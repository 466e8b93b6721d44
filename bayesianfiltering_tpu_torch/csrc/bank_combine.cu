// The associative Kalman filtering combine (K10), the RTS smoothing
// elements (K11) and the smoothing combine (K12), each over a bank of M
// lanes, in two size bands: dx ≤ 8 (the group kernels, `bank_*_kernel`)
// and 8 < dx ≤ 512, one thread block per lane (the block kernels after the
// group kernels below: K10b `tiled_combine_kernel`, K11b
// `block_smoother_elements_kernel` and K12b `tiled_smoother_combine_kernel`,
// built on csrc/block_mm.cuh).
//
// Replaces the TPU kernels bayesianfiltering_tpu/ops/bank_combine.py
// `_combine_kernel` (K10, body `_combine_lattice`) and
// bayesianfiltering_tpu/ops/bank_smoother.py `_elements_kernel` (K11) and
// `_smoother_combine_kernel` (K12). On the TPU the bank index lies along the
// 128 vector lanes and each scalar of the dx×dx lattice is one M-wide
// statement; the bank-major layout and its padding exist for that. Here
// tensors stay (M, dx, dx) row-major, and the lattice is padded to a
// static bound MX (4 for dx ≤ 4, else 8) so every loop unrolls: padded
// entries are zero and the padded diagonal of every matrix that is
// factored is one, so the padding changes nothing in the real block.
//
// Broadcast operands: the chunked scan combines (1, G, ...) with
// (chunk, G, ...). A side with Ml < M lanes is read at lane m % Ml, so the
// broadcast is never materialised. K11's transition F is shared by every
// lane (f_banked = 0) or given per lane.
//
// K10, K11 and K12 (the group kernels): a lane over a group of MX threads,
// on csrc/lane_group.cuh (layout, 16-byte row loads, the board, group_chol,
// launch shape: see there).
// - What bounds them on an H100: at path B's step-4 broadcast (1,000,064
//   lanes, dx = 4, float32) K10 and K12 must move 112 and 72 values a lane
//   and do ~1,300 and ~350 flops (chip_smoke.py combine_flops,
//   scombine_flops): bytes-bound, 0.134 and 0.086 ms. K11 runs once a
//   smoother run over 999,999 lanes and must move 76 values a lane (F
//   shared) for ~370 flops (elements_flops): bytes-bound, 0.091 ms. At the
//   scan's narrower levels (7,813, 62 and 1 lanes: 318 of path B's 320
//   launches of K10 and of K12) one lane's serial chain and the launch are
//   the whole cost.
// - Thread i holds row i of each of the lane's matrices (MX registers a
//   matrix, where one thread a lane had held ten MX × MX matrices); a
//   broadcast operand's lane m % Ml is read with the same 16-byte loads as
//   any lane. The board has kBoardSlots = 5 slots in K10 and K12,
//   kElementsSlots = 4 in K11 (padded by board_len, so that a warp's
//   column reads stay conflict-free).
// - The factors are column sweeps over the group (group_chol), and no
//   factor is inverted. K10's inner factor: [X | Y] = Lin⁻¹ [Uᵀ | (J2 U)ᵀ]
//   by forward substitution over the group, M⁻¹ = I − Xᵀ Y (as K10b). A
//   K10 lane's chain is then MX pivots twice, MX substitution steps and
//   ~12 products of one row each. K11's gain: each thread solves on its
//   own column of F Pf (a forward and a back substitution with Lp's rows
//   from the board, as K3 solves for its gain), which gives it row i of G
//   with no exchange a step; L = sym(Pf) − YᵀY with Y = Lp⁻¹ F Pf, the
//   one-factor identity of K11b.
// - 489 blocks at M = 7,813, spread over all 132 SMs.
//
// Math follows the port's plain versions (ops/associative.py `_combine`
// with `_minv_woodbury`, ops/bank_smoother.py `_elements_plain`,
// `_smoother_combine`):
//   K10  ε = 1e-7·tr(C1)/dx + 1e-30,  U = chol(C1 + εI),
//        inner = I + sym(Uᵀ J2 U),  M⁻¹ = I − U inner⁻¹ (J2 U)ᵀ,
//        A = A2 M⁻¹ A1,  b = A2 M⁻¹ (b1 + C1 η2) + b2,
//        C = sym(A2 M⁻¹ C1 A2ᵀ + C2),  η = A1ᵀ M⁻ᵀ (η2 − J2 b1) + η1,
//        J = sym(A1ᵀ M⁻ᵀ J2 A1 + J1).
//        Guard: U is zeroed unless every pivot of chol(C1 + εI) is positive
//        (then M⁻¹ = I), as utils/linalg.py `cholesky_guarded` zeroes the
//        factor that `cholesky_nan` NaNs when cholesky_ex reports failure.
//   K11  G = (Pp⁻¹ F Pf)ᵀ by chol(Pp) = Lp Lpᵀ and two triangular solves,
//        g = mf − G mp, L = sym(Pf) − YᵀY with Y = Lp⁻¹ F Pf (= sym(Pf −
//        G Pp Gᵀ)); a non-positive-definite Pp NaNs the lane, as psd_solve
//        does. No diagonal floor (the TPU kernel's 1e-30 kept its
//        zero-padded lanes factorable; padding here has unit pivots).
//   K12  E = E1 E2,  g = E1 g2 + g1,  L = sym(E1 L2 E1ᵀ + L1).
#include <algorithm>
#include <type_traits>

#include "block_mm.cuh"
#include "common.cuh"
#include "lane_group.cuh"

namespace {

using namespace bft;

// ---------------------------------------------------------------------------
// The group kernels K10, K11 and K12 (dx ≤ 8): a lane over a group of MX
// threads, thread i holding row i of every matrix of its lane in registers
// (MX entries), rows past dx zero.
// ---------------------------------------------------------------------------

constexpr int kBoardSlots = 5;     // slots of a group's board in K10 and K12
constexpr int kElementsSlots = 4;  // in K11

// K10. With thread i holding row i: U = chol(C1 + εI) (ε from the trace, a
// butterfly of shuffles; U zeroed unless every pivot is positive), then
// four products and the inner factor: J2 U, G = Uᵀ (J2 U), inner =
// I + sym(G), Lin = chol(inner); [X | Y] = Lin⁻¹ [Uᵀ | (J2 U)ᵀ] by forward
// substitution over the group (row k final at step k, read from the
// board), M⁻¹ = I − Xᵀ Y; then A = (A2 M⁻¹) A1, b = A2 M⁻¹ (b1 + C1 η2)
// + b2, C = sym(A2 M⁻¹ C1 A2ᵀ + C2), η = A1ᵀ (M⁻ᵀ (η2 − J2 b1)) + η1,
// J = sym(A1ᵀ (M⁻ᵀ J2 A1) + J1). A product's right operand is read from
// the board row by row (16 bytes a read, the group's threads on one
// address), a transposed left operand as a column; each exchange is one
// __syncwarp after the writes, and a slot is rewritten only after a
// __syncwarp has followed its last read.
template <typename T, int MX>
__global__ void __launch_bounds__(kGroupThreads) bank_combine_kernel(
    const T* __restrict__ A1g, const T* __restrict__ b1g,
    const T* __restrict__ C1g, const T* __restrict__ J1g,
    const T* __restrict__ e1g, const T* __restrict__ A2g,
    const T* __restrict__ b2g, const T* __restrict__ C2g,
    const T* __restrict__ J2g, const T* __restrict__ e2g, T* __restrict__ Ag,
    T* __restrict__ bg, T* __restrict__ Cg, T* __restrict__ Jg,
    T* __restrict__ eg, int M, int Ml, int Mr, int dx, int vec) {
  using Lane = GroupLane<T, MX, kBoardSlots>;
  __shared__ __align__(16) T boards[Lane::kBoards];
  if (warp_idle<MX>(M)) return;
  const Lane g(boards, M);
  const int i = g.i;
  const size_t l = Ml == M ? g.m : g.m % Ml;  // lane of the left operand
  const size_t r = Mr == M ? g.m : g.m % Mr;  // lane of the right operand
  const size_t o = g.m;
  const size_t dd = size_t(dx) * dx;
  T* S0 = g.slot(0);
  T* S1 = g.slot(1);
  T* S2 = g.slot(2);
  T* S3 = g.slot(3);
  T* S4 = g.slot(4);

  T a1[MX], c1[MX], j1[MX], a2[MX], c2[MX], j2[MX];
  load_row(a1, A1g + l * dd, i, dx, vec);
  load_row(c1, C1g + l * dd, i, dx, vec);
  load_row(j1, J1g + l * dd, i, dx, vec);
  load_row(a2, A2g + r * dd, i, dx, vec);
  load_row(c2, C2g + r * dd, i, dx, vec);
  load_row(j2, J2g + r * dd, i, dx, vec);
  const T b1 = load_entry(b1g + l * dx, i, dx);
  const T e1 = load_entry(e1g + l * dx, i, dx);
  const T b2 = load_entry(b2g + r * dx, i, dx);
  const T e2 = load_entry(e2g + r * dx, i, dx);

  // U = chol(C1 + εI), the padded diagonal one; zero unless every pivot
  // is positive
  const T tr = group_sum<T, MX>(i < dx ? entry(c1, i) : T(0));
  const T eps = T(1e-7) * tr / T(dx) + T(1e-30);
  T u[MX];
#pragma unroll
  for (int k = 0; k < MX; ++k)
    u[k] = c1[k] + (k == i ? (i < dx ? eps : T(1)) : T(0));
  T rinv;
  if (!group_chol(u, i, rinv)) {
#pragma unroll
    for (int k = 0; k < MX; ++k) u[k] = T(0);
  }

  // inner = I + sym(Uᵀ J2 U) and its factor
  put_row(S0, u, i);
  put_row(S1, j2, i);
  put_entry<T, MX>(S0, b1, i);
  put_entry<T, MX>(S1, e2, i);
  __syncwarp();
  T j2u[MX], ucol[MX], b1v[MX], e2v[MX];
  row_mul(j2u, j2, S0);  // J2 U
  get_col(ucol, S0, i);
  get_vec(b1v, S0);
  get_vec(e2v, S1);
  put_row(S2, j2u, i);
  __syncwarp();
  T gr[MX], jucol[MX];
  row_mul(gr, ucol, S2);  // G = Uᵀ (J2 U)
  get_col(jucol, S2, i);
  put_row(S3, gr, i);
  __syncwarp();
  T lin[MX];
  {
    T gc[MX];
    get_col(gc, S3, i);
#pragma unroll
    for (int k = 0; k < MX; ++k)
      lin[k] = T(0.5) * (gr[k] + gc[k]) + (k == i ? T(1) : T(0));
  }
  group_chol(lin, i, rinv);  // a failed pivot: NaN, which reaches every output

  // [X | Y] = Lin⁻¹ [Uᵀ | (J2 U)ᵀ] into S0 | S2, M⁻¹ = I − Xᵀ Y
#pragma unroll
  for (int k = 0; k < MX; ++k) {
    if (i == k) {
#pragma unroll
      for (int j = 0; j < MX; ++j) {
        ucol[j] *= rinv;
        jucol[j] *= rinv;
      }
      put_row(S0, ucol, k);
      put_row(S2, jucol, k);
    }
    __syncwarp();
    if (k + 1 < MX) {
      T xk[MX], yk[MX];
      get_row(xk, S0, k);
      get_row(yk, S2, k);
      if (i > k) {
#pragma unroll
        for (int j = 0; j < MX; ++j) {
          ucol[j] -= lin[k] * xk[j];
          jucol[j] -= lin[k] * yk[j];
        }
      }
    }
  }
  T minv[MX];
  {
    T xcol[MX];
    get_col(xcol, S0, i);
    row_mul(minv, xcol, S2);
#pragma unroll
    for (int k = 0; k < MX; ++k) minv[k] = (k == i ? T(1) : T(0)) - minv[k];
  }
  put_row(S3, minv, i);
  put_row(S4, a1, i);
  __syncwarp();

  // A = (A2 M⁻¹) A1; M⁻ᵀ J2 A1; the vectors b1 + C1 η2 and η2 − J2 b1
  T a2m[MX], mcol[MX], a1col[MX], p[MX];
  row_mul(a2m, a2, S3);  // A2 M⁻¹
  get_col(mcol, S3, i);
  get_col(a1col, S4, i);
  {
    T x[MX];
    row_mul(x, a2m, S4);
    if (g.live) store_row(Ag + o * dd, x, i, dx, vec);
    row_mul(x, mcol, S1);  // M⁻ᵀ J2
    row_mul(p, x, S4);     // M⁻ᵀ J2 A1
  }
  const T v = b1 + dot(c1, e2v);
  const T w = e2 - dot(j2, b1v);
  put_row(S0, c1, i);
  put_row(S2, p, i);
  put_entry<T, MX>(S0, v, i);
  put_entry<T, MX>(S2, w, i);
  __syncwarp();

  // b; A2 M⁻¹ C1; M⁻ᵀ w; Q = A1ᵀ (M⁻ᵀ J2 A1)
  T xc[MX], q[MX];
  row_mul(xc, a2m, S0);
  T t;
  {
    T vv[MX], ww[MX];
    get_vec(vv, S0);
    get_vec(ww, S2);
    if (g.live && i < dx) bg[o * dx + i] = dot(a2m, vv) + b2;
    t = dot(mcol, ww);
  }
  row_mul(q, a1col, S2);
  put_row(S1, a2, i);
  put_row(S3, q, i);
  put_row(S4, j1, i);
  put_entry<T, MX>(S1, t, i);
  __syncwarp();

  // W = (A2 M⁻¹ C1) A2ᵀ; J = sym(Q + J1); η = A1ᵀ t + η1
  T wr[MX];
  row_mul_t(wr, xc, S1);
  {
    T tv[MX], qc[MX], jc[MX], x[MX];
    get_vec(tv, S1);
    get_col(qc, S3, i);
    get_col(jc, S4, i);
#pragma unroll
    for (int k = 0; k < MX; ++k)
      x[k] = T(0.5) * ((q[k] + qc[k]) + (j1[k] + jc[k]));
    if (g.live) {
      store_row(Jg + o * dd, x, i, dx, vec);
      if (i < dx) eg[o * dx + i] = dot(a1col, tv) + e1;
    }
  }
  put_row(S0, wr, i);
  put_row(S2, c2, i);
  __syncwarp();

  // C = sym(W + C2)
  {
    T wc[MX], cc[MX], x[MX];
    get_col(wc, S0, i);
    get_col(cc, S2, i);
#pragma unroll
    for (int k = 0; k < MX; ++k)
      x[k] = T(0.5) * ((wr[k] + wc[k]) + (c2[k] + cc[k]));
    if (g.live) store_row(Cg + o * dd, x, i, dx, vec);
  }
}

// K12 on the groups of K10: E = E1 E2, g = E1 g2 + g1 and
// L = sym((E1 L2) E1ᵀ + L1), with E2, L2, E1 and L1 on the board for
// their rows and columns.
template <typename T, int MX>
__global__ void __launch_bounds__(kGroupThreads) bank_smoother_combine_kernel(
    const T* __restrict__ E1g, const T* __restrict__ g1g,
    const T* __restrict__ L1g, const T* __restrict__ E2g,
    const T* __restrict__ g2g, const T* __restrict__ L2g, T* __restrict__ Eg,
    T* __restrict__ gg, T* __restrict__ Lg, int M, int Ml, int Mr, int dx,
    int vec) {
  using Lane = GroupLane<T, MX, kBoardSlots>;
  __shared__ __align__(16) T boards[Lane::kBoards];
  if (warp_idle<MX>(M)) return;
  const Lane g(boards, M);
  const int i = g.i;
  const size_t l = Ml == M ? g.m : g.m % Ml;
  const size_t r = Mr == M ? g.m : g.m % Mr;
  const size_t o = g.m;
  const size_t dd = size_t(dx) * dx;
  T* S0 = g.slot(0);
  T* S1 = g.slot(1);
  T* S2 = g.slot(2);
  T* S3 = g.slot(3);
  T* S4 = g.slot(4);

  T e1[MX], l1[MX], e2[MX], l2[MX];
  load_row(e1, E1g + l * dd, i, dx, vec);
  load_row(l1, L1g + l * dd, i, dx, vec);
  load_row(e2, E2g + r * dd, i, dx, vec);
  load_row(l2, L2g + r * dd, i, dx, vec);
  const T g1 = load_entry(g1g + l * dx, i, dx);
  const T g2 = load_entry(g2g + r * dx, i, dx);
  put_row(S0, e2, i);
  put_row(S1, l2, i);
  put_row(S2, e1, i);
  put_row(S3, l1, i);
  put_entry<T, MX>(S0, g2, i);
  __syncwarp();

  T x[MX], y[MX];
  row_mul(x, e1, S0);  // E1 E2
  if (g.live) store_row(Eg + o * dd, x, i, dx, vec);
  {
    T g2v[MX];
    get_vec(g2v, S0);
    if (g.live && i < dx) gg[o * dx + i] = dot(e1, g2v) + g1;
  }
  row_mul(x, e1, S1);    // E1 L2
  row_mul_t(y, x, S2);   // (E1 L2) E1ᵀ
  put_row(S4, y, i);
  __syncwarp();
  {
    T yc[MX], lc[MX];
    get_col(yc, S4, i);
    get_col(lc, S3, i);
#pragma unroll
    for (int k = 0; k < MX; ++k)
      x[k] = T(0.5) * ((y[k] + yc[k]) + (l1[k] + lc[k]));
    if (g.live) store_row(Lg + o * dd, x, i, dx, vec);
  }
}

// K11 on the groups of K10, thread i holding row i of Pf, Pp and F (a
// shared F read by every group, as K4 reads its shared Q), four slots:
//   1. Pf | mp and F to the board; Lp = chol(Pp) by group_chol (over dx
//      pivots in the groups of 4 threads, every pivot in those of 8, the
//      padded rows the identity's); a failed pivot sets Lp and its
//      pivots' reciprocals to NaN, which reaches G, g and L; Lp | 1/diag
//      to the board;
//   2. thread i forms column i of X = F Pf (Pf's column i read from the
//      board, F's rows from the board: no exchange of X), solves Lp y =
//      X[:, i] forward (y = column i of Y = Lp⁻¹ F Pf) and Lpᵀ e = y back
//      with Lp's rows from the board: e is row i of G = (Pp⁻¹ F Pf)ᵀ (Lp⁻¹
//      never formed); y to the board as row i of Yᵀ;
//   3. L = sym(Pf) − YᵀY, row i: entry j is y_i · y_j over the board's
//      rows (exactly symmetric), sym(Pf) from Pf's column i;
//      g_i = mf_i − e · mp with mp read from the board 16 bytes at a time.
template <typename T, int MX>
__global__ void __launch_bounds__(kGroupThreads) bank_smoother_elements_kernel(
    const T* __restrict__ fmg, const T* __restrict__ fPg,
    const T* __restrict__ pmg, const T* __restrict__ pPg,
    const T* __restrict__ Fg, T* __restrict__ Eg, T* __restrict__ gg,
    T* __restrict__ Lg, int M, int f_banked, int dx, int vec) {
  using Lane = GroupLane<T, MX, kElementsSlots>;
  __shared__ __align__(16) T boards[Lane::kBoards];
  if (warp_idle<MX>(M)) return;
  const Lane g(boards, M);
  const int i = g.i;
  const size_t o = g.m;
  const size_t dd = size_t(dx) * dx;
  T* SP = g.slot(0);  // Pf | mp
  T* SF = g.slot(1);  // F
  T* SL = g.slot(2);  // Lp | 1/diag(Lp)
  T* SY = g.slot(3);  // Yᵀ
  // the bound of the factor and the solves: dx in the groups of 4 threads,
  // MX (every pivot, the padded ones unit) in those of 8
  const int nx = MX == 4 ? dx : MX;

  T pf[MX], lp[MX];
  {
    T f[MX];
    load_row(pf, fPg + o * dd, i, dx, vec);
    load_row(lp, pPg + o * dd, i, dx, vec);
    load_row(f, Fg + (f_banked ? o * dd : 0), i, dx, vec);
    put_row(SP, pf, i);
    put_row(SF, f, i);
    put_entry<T, MX>(SP, load_entry(pmg + o * dx, i, dx), i);
  }
  const T mf = load_entry(fmg + o * dx, i, dx);

  // Lp = chol(Pp), the padded diagonal one; NaN unless every pivot is
  // positive
#pragma unroll
  for (int k = 0; k < MX; ++k)
    if (k == i && i >= dx) lp[k] = T(1);
  T rinv = T(1);
  if (!group_chol(lp, i, rinv, nx)) {
#pragma unroll
    for (int k = 0; k < MX; ++k) lp[k] = qnan<T>();
    rinv = qnan<T>();
  }
  put_row(SL, lp, i);
  put_entry<T, MX>(SL, rinv, i);
  __syncwarp();

  // X[:, i] = F Pf[:, i]; Lp y = X[:, i]; Lpᵀ e = y
  T y[MX], e[MX];
  {
    T pfc[MX], rl[MX];
    get_col(pfc, SP, i);
    row_mul_t(y, pfc, SF);
    get_vec(rl, SL);
#pragma unroll
    for (int j = 0; j < MX; ++j) {
      if (j < nx) {
        T lj[MX];
        get_row(lj, SL, j);
        T a = y[j];
#pragma unroll
        for (int k = 0; k < j; ++k) a -= lj[k] * y[k];
        y[j] = a * rl[j];
      }
    }
    put_row(SY, y, i);
#pragma unroll
    for (int k = 0; k < MX; ++k) e[k] = y[k];
#pragma unroll
    for (int j = MX - 1; j >= 0; --j) {
      if (j < nx) {
        T lj[MX];
        get_row(lj, SL, j);
        e[j] *= rl[j];
#pragma unroll
        for (int k = 0; k < j; ++k) e[k] -= lj[k] * e[j];
      }
    }
  }
  __syncwarp();

  // L = sym(Pf) − YᵀY and g = mf − G mp, row i
  if (g.live) {
    T w[MX], pfc[MX], mp[MX];
    row_mul_t(w, y, SY);
    get_col(pfc, SP, i);
    get_vec(mp, SP);
#pragma unroll
    for (int k = 0; k < MX; ++k) w[k] = T(0.5) * (pf[k] + pfc[k]) - w[k];
    store_row(Eg + o * dd, e, i, dx, vec);
    store_row(Lg + o * dd, w, i, dx, vec);
    if (i < dx) gg[o * dx + i] = mf - dot(e, mp);
  }
}

template <typename T>
int launch_combine(const void* const* in, void* const* out, int M, int Ml,
                   int Mr, int dx, void* stream) {
  auto kernel = dx <= 4 ? bank_combine_kernel<T, 4> : bank_combine_kernel<T, 8>;
  const T* const* x = reinterpret_cast<const T* const*>(in);
  T* const* y = reinterpret_cast<T* const*>(out);
  const int vec = rows_vec<T>(dx, {in[0], in[2], in[3], in[5], in[7], in[8],
                                   out[0], out[2], out[3]});
  kernel<<<group_blocks(M, dx <= 4 ? 4 : 8), kGroupThreads, 0,
           cudaStream_t(stream)>>>(x[0], x[1], x[2], x[3], x[4], x[5], x[6],
                                   x[7], x[8], x[9], y[0], y[1], y[2], y[3],
                                   y[4], M, Ml, Mr, dx, vec);
  return int(cudaGetLastError());
}

template <typename T>
int launch_elements(const void* fm, const void* fP, const void* pm,
                    const void* pP, const void* F, void* E, void* g, void* L,
                    int M, int f_banked, int dx, void* stream) {
  auto kernel = dx <= 4 ? bank_smoother_elements_kernel<T, 4>
                        : bank_smoother_elements_kernel<T, 8>;
  const int vec = rows_vec<T>(dx, {fP, pP, F, E, L});
  kernel<<<group_blocks(M, dx <= 4 ? 4 : 8), kGroupThreads, 0,
           cudaStream_t(stream)>>>(
      static_cast<const T*>(fm), static_cast<const T*>(fP),
      static_cast<const T*>(pm), static_cast<const T*>(pP),
      static_cast<const T*>(F), static_cast<T*>(E), static_cast<T*>(g),
      static_cast<T*>(L), M, f_banked, dx, vec);
  return int(cudaGetLastError());
}

template <typename T>
int launch_scombine(const void* E1, const void* g1, const void* L1,
                    const void* E2, const void* g2, const void* L2, void* E,
                    void* g, void* L, int M, int Ml, int Mr, int dx,
                    void* stream) {
  auto kernel = dx <= 4 ? bank_smoother_combine_kernel<T, 4>
                        : bank_smoother_combine_kernel<T, 8>;
  const int vec = rows_vec<T>(dx, {E1, L1, E2, L2, E, L});
  kernel<<<group_blocks(M, dx <= 4 ? 4 : 8), kGroupThreads, 0,
           cudaStream_t(stream)>>>(
      static_cast<const T*>(E1), static_cast<const T*>(g1),
      static_cast<const T*>(L1), static_cast<const T*>(E2),
      static_cast<const T*>(g2), static_cast<const T*>(L2),
      static_cast<T*>(E), static_cast<T*>(g), static_cast<T*>(L), M, Ml, Mr,
      dx, vec);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The block kernels, 8 < dx ≤ 512: the same three functions, one thread
// block per lane.
//
// The chunked scan launches these over anything from one lane (its top
// level) to T lanes (its last broadcast, 65,536 at T = 65,536), so the grid
// is persistent: min(M, what the SMs hold at once) blocks, each looping over
// lanes m = blockIdx.x, blockIdx.x + gridDim.x, ... A workspace in global
// scratch is then bounded by the blocks in flight (kScratchBlocksPerSM per
// SM), not by M.
//
// K10b and K12b (tiled_combine_kernel, tiled_smoother_combine_kernel) are
// built for the H100 from csrc/block_mm.cuh:
// - What bounds them: the products run on the CUDA cores in the working
//   type (TF32 is off). At dx = 64 in float32 K10b does ~32 flops per byte
//   it must move, above the card's ratio of 20, so it is operation-bound at
//   full width; K12b (~14) is bytes-bound there. At the scan's narrow levels
//   (1 or 4 lanes, 132 launches of path C's 262) a lane's serial chain is
//   the whole cost: the first design spent ~0.6 ms on one lane, with every
//   product a chain of dependent multiply-adds at two shared loads each and
//   one barrier per factor column.
// - Products: one register-tiled product (tile_mm) for all of them. A
//   thread owns a TM × TN tile of outputs (4 × 4 at dx = 64 over 256
//   threads), in independent accumulators, and reads a TM-span of A and a
//   TN-span of B a step, 16 bytes a load: a quarter of the shared loads per
//   multiply-add and 16 independent chains. Transposed operands are taken
//   by layout (A in either orientation; an operand needed as a transposed
//   B is staged or stored transposed once: A2ᵀ and E1ᵀ by element copies
//   along a conflict-free diagonal walk, (J2 U)ᵀ by the product's own
//   epilogue). K12b computes only the lower half of E1 L2 E1ᵀ.
// - Factors: K10b's two Cholesky factors are common.cuh's panel factor
//   (five barriers at dx = 64). U = chol(C1 + εI) is zeroed unless every
//   pivot is positive (the guard, M⁻¹ = I); the factor's epilogue zeroes
//   U's strict upper part (which the panel factor leaves as it was) and
//   writes U a second time, row-major. The inner factor is never inverted:
//   M⁻¹ = I − U inner⁻¹ (J2 U)ᵀ = I − Xᵀ Y with X = L⁻¹ Uᵀ and
//   Y = L⁻¹ (J2 U)ᵀ, two right-hand sides of one panel triangular solve,
//   whose pivots' reciprocals are NaN unless every pivot of the inner
//   matrix was positive (cholesky_nan: the lane is NaN throughout).
// - Matrix-vector products: the whole block, a warp a row (mv_rows) or
//   split along k into parts summed after a barrier (mv_cols).
// - Staging: inputs are copied once into the workspace, 16 bytes a copy
//   where the rows allow it; in shared memory by cp.async, issued early
//   where a buffer is free so that the copy lands under other work (A2ᵀ
//   under the inner factor, A1 under A2M C1, the next lane's C1 and J2, or
//   E1ᵀ, E2, L2, under the current lane's last passes). Outputs are written
//   16 bytes a store from registers (A, E) or from the workspace (C, J, L).
// - Symmetric outputs: sym(X + Y) is formed in place, one thread for each
//   pair (i, j), (j, i) along the diagonal walk, then stored row by row.
// - Launch shape, chosen by the caller (ops/bank_combine.py block_tile,
//   block_threads): the workspace in shared memory with a leading
//   dimension of kTile = 64 where dx ≤ 64 and it fits (K10b: six 64²
//   matrices, four vectors and the partial sums of mv_cols; K12b five
//   matrices and the partial sums: both dtypes on an H100), else in global
//   scratch with ld = dx rounded up to 64 (the same code, plain copies for
//   cp.async). K10b runs 512 threads (tiles 4 × 2) where the lanes fit one
//   block an SM (M ≤ the SM count) on the tile in float32, so that one
//   lane's chain is short, else 256; K12b runs 256.
//
// K11b (block_smoother_elements_kernel) is built the same way:
// - What bounds it: at path C's shape (65,535 lanes, dx = 64, F shared) a
//   lane needs ~16n³/3 flops (chip_smoke.py elements_flops: the factor,
//   F Pf, a forward and a back solve, the symmetric YᵀY) against
//   4n² + 3n values moved (F once): 1.38 ms of operations in float32
//   against 1.30 ms of bytes, so it is operation-bound at full width; a
//   block waits on the serial chains of its factor and solve and on its
//   barriers (12 a lane at dx = 64 in float32, 22 in float64), which two
//   blocks an SM (float32) overlap.
// - One factor and one solve: with Y = Lp⁻¹ F Pf, G = Yᵀ Lp⁻¹,
//   G mp = Yᵀ (Lp⁻¹ mp) and (G Lp)(G Lp)ᵀ = YᵀY. The lane's block X holds
//   [Pp | F Pf | mp | I] in ld rows; the panel factor turns lower(Pp) into
//   Lp in place, and one panel triangular solve gives
//   [Y | z | Lp⁻¹] = Lp⁻¹ [F Pf | mp | I]. Where Pp is not positive
//   definite the pivots' reciprocals are NaN, so that every output of the
//   lane is NaN, as the plain version's psd_solve gives.
// - Products: F Pf, E = Yᵀ Lp⁻¹ (stored from registers, 16 bytes a store
//   where the rows allow it) and the packed lower tiles of YᵀY
//   (tile_mm_lower), whose epilogue forms L = sym(Pf) − YᵀY in place in
//   Pf, each tile with its mirror; g = mf − Yᵀ z is one block
//   matrix-vector product.
// - Staging: a shared F is staged once for the block's whole loop; Pp, Pf,
//   mp and a banked F by cp.async, the next lane's under the current
//   lane's store of L (Pf in two buffers: one buffer, its copy after the
//   store, ran 1.1% slower in float32 and 1.4% in float64 on an H100).
// - Launch shape: as K12b's (256 threads; the tile 64 where dx ≤ 64 and
//   the workspace fits, 27,200 elements: 109 KB in float32, two blocks an
//   SM, 218 KB in float64, one; else global scratch), the factor and the
//   solve in panels of kElementsPanel (32 in float32, 16 in float64).
// ---------------------------------------------------------------------------

constexpr int kBlockThreads = 256;
constexpr int kScratchBlocksPerSM = 2;

// The width of K11b's block X at leading dimension ld: [Pp | F Pf | mp |
// pad | I] with F Pf from column ld and I from the first 16-byte boundary
// after mp, both within ld + n + 4 + ld ≤ 3ld + 4, rounded up to 32.
__host__ __device__ constexpr int elements_ldx(int ld) { return 3 * ld + 32; }

// The workspaces of K10b, K11b and K12b (kinds 0, 1 and 2 of
// ops/bank_combine.py tiled_ws) at leading dimension ld: K10b six ld × ld
// matrices, four vectors and mv_cols' partial sums; K11b F and two Pf
// buffers (ld × ld), its block X (ld rows of elements_ldx(ld)), the
// pivots' reciprocals and the partial sums; K12b five matrices and the
// partial sums. The partial sums take max(512, ld): enough for either
// block size.
__host__ __device__ constexpr size_t tiled_ws(int kind, int ld) {
  return kind == 1 ? 3 * size_t(ld) * ld + size_t(ld) * elements_ldx(ld) +
                         ld + size_t(ld > 512 ? ld : 512)
                   : (kind == 0 ? 6 : 5) * size_t(ld) * ld +
                         (kind == 0 ? 4 * ld : 0) +
                         size_t(ld > 512 ? ld : 512);
}

// The leading dimension of a tiled workspace: the tile, or on the global
// route (tile 0) dx rounded up to the 64 × 64 super-tile of 256 threads.
__host__ __device__ constexpr int tiled_ld(int tile, int n) {
  return tile ? tile : (n + 63) / 64 * 64;
}

// The shared-memory route's leading dimension (ops/bank_combine.py TILE).
constexpr int kTile = 64;

// The register tiles: a 64 × 64 super-tile on either route, over NT threads
// laid out 16 × NT/16 (4 × 4 a thread at 256 threads, 4 × 2 at 512).
template <int NT>
struct Tiling {
  static constexpr int TM = 4;
  static constexpr int TN = 64 / (NT / 16);
  static_assert(TN * (NT / 16) == 64, "tile shape");
};

// The epilogues of tile_mm that K10b and K12b use: a tile into a workspace
// matrix (ld), row by row or transposed, into a global output (rows of n,
// `vec` when they are 16-byte aligned), or as I − tile.
template <typename T, int TM, int TN>
struct Put {
  int n;
  __device__ auto rows(T* X, int ld) const {
    const int n_ = n;
    return [=](int i0, int j0, const T (&acc)[TM][TN]) {
      put_rows<false>(X, ld, i0, j0, acc, n_, n_, 0, true,
                      [](T v, int, int) { return v; });
    };
  }
  __device__ auto out(T* X, bool vec) const {
    const int n_ = n;
    return [=](int i0, int j0, const T (&acc)[TM][TN]) {
      put_rows<false>(X, n_, i0, j0, acc, n_, n_, 0, vec,
                      [](T v, int, int) { return v; });
    };
  }
  __device__ auto cols(T* X, int ld) const {
    const int n_ = n;
    return [=](int i0, int j0, const T (&acc)[TM][TN]) {
      put_cols(X, ld, i0, j0, acc, n_, n_);
    };
  }
  __device__ auto eye_minus(T* X, int ld) const {
    const int n_ = n;
    return [=](int i0, int j0, const T (&acc)[TM][TN]) {
      put_rows<false>(X, ld, i0, j0, acc, n_, n_, 0, true, [](T v, int i, int j) {
        return (i == j ? T(1) : T(0)) - v;
      });
    };
  }
};

// X (ld) += G (n × n, row-major, global), rows of X coalesced.
template <typename T>
__device__ void add_in(T* X, int ld, const T* G, int n) {
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    const int i = idx / n, j = idx - i * n;
    X[i * ld + j] += G[idx];
  }
}

// The symmetric part of X (ld) in place: one thread for each pair.
template <typename T>
__device__ void sym_in(T* X, int ld, int n) {
  diag_walk((n + kWarp - 1) / kWarp * kWarp, [&](int i, int j) {
    if (i < n && j < i) {
      const T v = T(0.5) * (X[i * ld + j] + X[j * ld + i]);
      X[i * ld + j] = v;
      X[j * ld + i] = v;
    }
  });
}

// out (n × n, global) ← X (ld): 16 bytes a store where the rows allow it.
template <typename T>
__device__ void copy_out(T* out, const T* X, int ld, int n, bool vec) {
  constexpr int V = 16 / sizeof(T);
  using W = typename Vec<T, V>::type;
  if (vec) {
    const int nv = n / V;
    for (int idx = threadIdx.x; idx < n * nv; idx += blockDim.x) {
      const int i = idx / nv, c = (idx - i * nv) * V;
      *reinterpret_cast<W*>(out + size_t(i) * n + c) =
          *reinterpret_cast<const W*>(X + i * ld + c);
    }
  } else {
    for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
      const int i = idx / n, j = idx - i * n;
      out[idx] = X[i * ld + j];
    }
  }
}

// K10b: the Woodbury combine of one lane per loop iteration. TILE > 0: the
// workspace in dynamic shared memory with ld = TILE ≥ n; TILE = 0: in the
// caller's global scratch with ld = n rounded up to 64. The comments name
// the workspace matrices B0..B5 as they are reused.
template <typename T, int TILE, int NT>
__global__ void __launch_bounds__(NT, (NT == 256 && sizeof(T) == 4) ? 2 : 1)
    tiled_combine_kernel(const T* __restrict__ A1g, const T* __restrict__ b1g,
                         const T* __restrict__ C1g, const T* __restrict__ J1g,
                         const T* __restrict__ e1g, const T* __restrict__ A2g,
                         const T* __restrict__ b2g, const T* __restrict__ C2g,
                         const T* __restrict__ J2g, const T* __restrict__ e2g,
                         T* __restrict__ Ag, T* __restrict__ bg,
                         T* __restrict__ Cg, T* __restrict__ Jg,
                         T* __restrict__ eg, int M, int Ml, int Mr, int n,
                         T* scratch) {
  constexpr bool kSmem = TILE > 0;
  constexpr int TM = Tiling<NT>::TM, TN = Tiling<NT>::TN;
  __shared__ int s_bad;
  __shared__ T s_eps;
  const int tid = threadIdx.x;
  const int ld = tiled_ld(TILE, n);
  const size_t LL = size_t(ld) * ld, dd = size_t(n) * n;
  T* B0 = kSmem ? shared_workspace<T>()
                : scratch + size_t(blockIdx.x) * tiled_ws(0, ld);
  T* B1 = B0 + LL;
  T* B2 = B1 + LL;
  T* B3 = B2 + LL;
  T* B4 = B3 + LL;
  T* B5 = B4 + LL;
  T* v0 = B5 + LL;   // b1 + C1 η2
  T* v1 = v0 + ld;   // η2 − J2 b1
  T* v2 = v1 + ld;   // M⁻ᵀ (η2 − J2 b1)
  T* dinv = v2 + ld;  // the inner factor's pivots' reciprocals
  T* part = dinv + ld;
  const Put<T, TM, TN> put{n};
  // C = A B over n × n, A(i, k) = A[k·ld + i] (at) or A[i·ld + k] (rows)
  const auto mm = [&](auto layout, const T* A, const T* B, auto epi) {
    tile_mm<T, NT, TM, TN, decltype(layout)::value>(A, ld, B, ld, n, n, n, 0,
                                                    false, epi);
  };
  const std::true_type at{};
  const std::false_type rows{};
  const int ext = (n + kWarp - 1) / kWarp * kWarp;
  bool staged = false;  // this lane's C1 and J2 are in B0 and B1

  for (int m = blockIdx.x; m < M; m += gridDim.x) {
    const size_t l = Ml == M ? m : m % Ml;  // lane of the left operand
    const size_t r = Mr == M ? m : m % Mr;  // lane of the right operand
    const T* A1 = A1g + l * dd;
    const T* C1 = C1g + l * dd;
    const T* J1 = J1g + l * dd;
    const T* b1 = b1g + l * n;
    const T* e1 = e1g + l * n;
    const T* A2 = A2g + r * dd;
    const T* C2 = C2g + r * dd;
    const T* J2 = J2g + r * dd;
    const T* b2 = b2g + r * n;
    const T* e2 = e2g + r * n;
    T* A = Ag + size_t(m) * dd;
    T* C = Cg + size_t(m) * dd;
    T* J = Jg + size_t(m) * dd;

    // B0 = C1, B1 = J2
    if (!staged) {
      stage<T, kSmem>(B0, ld, C1, n);
      stage<T, kSmem>(B1, ld, J2, n);
    }
    if (kSmem) {
      cp_async_commit();
      cp_async_wait_all();
    }
    __syncthreads();
    // ε = 1e-7·tr(C1)/dx + 1e-30; v0 = b1 + C1 η2, v1 = η2 − J2 b1
    if (tid < kWarp) {
      T tr = T(0);
      for (int i = tid; i < n; i += kWarp) tr += B0[i * ld + i];
      tr = warp_sum(tr);
      if (tid == 0) {
        s_eps = T(1e-7) * tr / T(n) + T(1e-30);
        s_bad = 0;
      }
    }
    mv_rows(B0, ld, e2, n, [&](int i, T s) { v0[i] = b1[i] + s; });
    mv_rows(B1, ld, b1, n, [&](int i, T s) { v1[i] = e2[i] - s; });
    __syncthreads();
    // B2 = the lower triangle of C1 + εI, column-major, factored in place:
    // U, zeroed unless every pivot is positive (then M⁻¹ = I)
    const T eps = s_eps;
    diag_walk(ext, [&](int i, int j) {
      if (i < n && j <= i)
        B2[j * ld + i] = B0[i * ld + j] + (i == j ? eps : T(0));
    });
    __syncthreads();
    block_cholesky_panels(B2, n, &s_bad, ld);
    const bool bad_u = s_bad != 0;
    // B2 = Uᵀ row-major (U's strict upper part zeroed), B3 = U
    diag_walk(ext, [&](int i, int k) {
      if (i < n && k < n) {
        const T u = !bad_u && i >= k ? B2[k * ld + i] : T(0);
        B2[k * ld + i] = u;
        B3[i * ld + k] = u;
      }
    });
    __syncthreads();
    mm(rows, B1, B3, put.cols(B4, ld));  // B4 = (J2 U)ᵀ
    __syncthreads();
    mm(rows, B4, B3, put.rows(B5, ld));  // B5 = (J2 U)ᵀ U = (Uᵀ J2 U)ᵀ
    __syncthreads();
    // B3 = A2ᵀ (U is dead), landing under the inner factor and the solve
    stage_t<T, kSmem>(B3, ld, A2, n);
    if (kSmem) cp_async_commit();
    // inner = I + sym(Uᵀ J2 U): its lower triangle column-major in place
    diag_walk(ext, [&](int i, int j) {
      if (i < n && j <= i) {
        const T g = T(0.5) * (B5[i * ld + j] + B5[j * ld + i]);
        B5[j * ld + i] = i == j ? g + T(1) : g;
      }
    });
    if (tid == 0) s_bad = 0;
    __syncthreads();
    block_cholesky_panels(B5, n, &s_bad, ld);
    // NaN throughout unless every pivot is positive (cholesky_nan)
    const bool bad_inner = s_bad != 0;
    for (int i = tid; i < ld; i += NT)
      dinv[i] = bad_inner ? qnan<T>() : i < n ? T(1) / B5[i * ld + i] : T(1);
    __syncthreads();
    // B2 = X = L⁻¹ Uᵀ, B4 = Y = L⁻¹ (J2 U)ᵀ; M⁻¹ = I − Xᵀ Y into B5
    block_tri_solve<T, NT, TM, TN>(B5, dinv, B2, n, B4, n, n, ld);
    mm(at, B2, B4, put.eye_minus(B5, ld));
    if (kSmem) cp_async_wait_all();
    __syncthreads();
    // B2 = M⁻ᵀ J2, B4 = A2M = A2 M⁻¹, v2 = M⁻ᵀ v1
    mm(at, B5, B1, put.rows(B2, ld));
    mm(at, B3, B5, put.rows(B4, ld));
    mv_cols(B5, ld, v1, n, part, [&](int i, T s) { v2[i] = s; });
    __syncthreads();
    // B1 = A1 (J2 is dead), landing under A2M C1
    stage<T, kSmem>(B1, ld, A1, n);
    if (kSmem) cp_async_commit();
    // B5 = A2M C1; b = A2M (b1 + C1 η2) + b2
    mm(rows, B4, B0, put.rows(B5, ld));
    mv_rows(B4, ld, v0, n,
            [&](int i, T s) { bg[size_t(m) * n + i] = s + b2[i]; });
    if (kSmem) cp_async_wait_all();
    __syncthreads();
    // B0 = (M⁻ᵀ J2) A1; A = A2M A1; η = A1ᵀ v2 + η1
    mm(rows, B2, B1, put.rows(B0, ld));
    mm(rows, B4, B1, put.out(A, rows_aligned(Ag, n)));
    mv_cols(B1, ld, v2, n, part,
            [&](int i, T s) { eg[size_t(m) * n + i] = s + e1[i]; });
    __syncthreads();
    // B2 = A1ᵀ (M⁻ᵀ J2 A1); B4 = A2M C1 A2ᵀ
    mm(at, B1, B0, put.rows(B2, ld));
    mm(rows, B5, B3, put.rows(B4, ld));
    __syncthreads();
    // the next lane's C1 and J2 into B0 and B1 (both dead), landing under
    // the symmetric parts
    const int next = m + int(gridDim.x);
    staged = kSmem && next < M;
    if (staged) {
      stage<T, kSmem>(B0, ld, C1g + (Ml == M ? next : next % Ml) * dd, n);
      stage<T, kSmem>(B1, ld, J2g + (Mr == M ? next : next % Mr) * dd, n);
    }
    // J = sym(A1ᵀ M⁻ᵀ J2 A1 + J1), C = sym(A2M C1 A2ᵀ + C2)
    add_in(B2, ld, J1, n);
    add_in(B4, ld, C2, n);
    __syncthreads();
    sym_in(B2, ld, n);
    sym_in(B4, ld, n);
    __syncthreads();
    copy_out(J, B2, ld, n, rows_aligned(Jg, n));
    copy_out(C, B4, ld, n, rows_aligned(Cg, n));
  }
}

// K12b: the smoothing combine of one lane per loop iteration, on the same
// routes as K10b.
template <typename T, int TILE, int NT>
__global__ void __launch_bounds__(NT, (NT == 256 && sizeof(T) == 4) ? 2 : 1)
    tiled_smoother_combine_kernel(
        const T* __restrict__ E1g, const T* __restrict__ g1g,
        const T* __restrict__ L1g, const T* __restrict__ E2g,
        const T* __restrict__ g2g, const T* __restrict__ L2g,
        T* __restrict__ Eg, T* __restrict__ gg, T* __restrict__ Lg, int M,
        int Ml, int Mr, int n, T* scratch) {
  constexpr bool kSmem = TILE > 0;
  constexpr int TM = Tiling<NT>::TM, TN = Tiling<NT>::TN;
  const int ld = tiled_ld(TILE, n);
  const size_t LL = size_t(ld) * ld, dd = size_t(n) * n;
  T* B0 = kSmem ? shared_workspace<T>()
                : scratch + size_t(blockIdx.x) * tiled_ws(2, ld);
  T* B1 = B0 + LL;  // E2, then W = E1 L2 E1ᵀ
  T* B2 = B1 + LL;  // L2
  T* B3 = B2 + LL;  // X = E1 L2
  T* B4 = B3 + LL;  // L1, then L
  T* part = B4 + LL;
  const Put<T, TM, TN> put{n};
  bool staged = false;  // this lane's E1ᵀ, E2 and L2 are in B0..B2

  for (int m = blockIdx.x; m < M; m += gridDim.x) {
    const size_t l = Ml == M ? m : m % Ml;
    const size_t r = Mr == M ? m : m % Mr;
    const T* E1 = E1g + l * dd;
    const T* g1 = g1g + l * n;
    const T* g2 = g2g + r * n;
    const int next = m + int(gridDim.x);
    const size_t ln = Ml == M ? next : next % Ml;
    const size_t rn = Mr == M ? next : next % Mr;

    __syncthreads();  // the last lane's L is out of B4
    stage<T, kSmem>(B4, ld, L1g + l * dd, n);
    if (!staged) {
      stage_t<T, kSmem>(B0, ld, E1, n);
      stage<T, kSmem>(B1, ld, E2g + r * dd, n);
      stage<T, kSmem>(B2, ld, L2g + r * dd, n);
    }
    if (kSmem) {
      cp_async_commit();
      cp_async_wait_all();
    }
    __syncthreads();
    // E = E1 E2 (out from registers); B3 = E1 L2; g = E1 g2 + g1
    tile_mm<T, NT, TM, TN, true>(B0, ld, B1, ld, n, n, n, 0, false,
                                 put.out(Eg + size_t(m) * dd,
                                         rows_aligned(Eg, n)));
    tile_mm<T, NT, TM, TN, true>(B0, ld, B2, ld, n, n, n, 0, false,
                                 put.rows(B3, ld));
    mv_cols(B0, ld, g2, n, part,
            [&](int i, T s) { gg[size_t(m) * n + i] = s + g1[i]; });
    __syncthreads();
    // B1 = W = (E1 L2) E1ᵀ, its lower half
    tile_mm<T, NT, TM, TN, false>(B3, ld, B0, ld, n, n, n, 0, true,
                                  put.rows(B1, ld));
    __syncthreads();
    staged = kSmem && next < M;
    if (staged) {  // the next lane's E1ᵀ and L2 (B0, B2 are dead)
      stage_t<T, kSmem>(B0, ld, E1g + ln * dd, n);
      stage<T, kSmem>(B2, ld, L2g + rn * dd, n);
    }
    // L = sym(W + L1) in B4, W read from its lower half
    diag_walk((n + kWarp - 1) / kWarp * kWarp, [&](int i, int j) {
      if (i < n && j <= i) {
        const T w = B1[i * ld + j];
        const T v = T(0.5) * ((w + B4[i * ld + j]) + (w + B4[j * ld + i]));
        B4[i * ld + j] = v;
        B4[j * ld + i] = v;
      }
    });
    __syncthreads();
    if (staged) stage<T, kSmem>(B1, ld, E2g + rn * dd, n);  // W is dead
    copy_out(Lg + size_t(m) * dd, B4, ld, n, rows_aligned(Lg, n));
  }
}

// K11b's panel width, the factor of Pp's and the solve's against it: 32
// in float32, 16 in float64 (the faster of 8, 16 and 32 in each at path C
// on an H100; PERF.md §6).
template <typename T>
constexpr int kElementsPanel = sizeof(T) == 4 ? 32 : 16;

// K11b: the RTS elements of one lane per loop iteration, on the same routes
// as K10b. X, the lane's block (ld rows, leading dimension ldx), holds
// [Pp, then Lp | F Pf, then Y | mp, then z | pad | I, then Lp⁻¹]; Lp is
// held column-major in X's first columns (X[k·ldx + i] = Lp[i][k]).
template <typename T, int TILE, int NT>
__global__ void __launch_bounds__(NT, (NT == 256 && sizeof(T) == 4) ? 2 : 1)
    block_smoother_elements_kernel(
        const T* __restrict__ fmg, const T* __restrict__ fPg,
        const T* __restrict__ pmg, const T* __restrict__ pPg,
        const T* __restrict__ Fg, T* __restrict__ Eg, T* __restrict__ gg,
        T* __restrict__ Lg, int M, int f_banked, int n, T* scratch) {
  constexpr bool kSmem = TILE > 0;
  constexpr int TM = Tiling<NT>::TM, TN = Tiling<NT>::TN;
  constexpr int W = kElementsPanel<T>;
  __shared__ int s_bad;
  const int tid = threadIdx.x;
  const int ld = tiled_ld(TILE, n), ldx = elements_ldx(ld);
  const size_t LL = size_t(ld) * ld, dd = size_t(n) * n;
  T* Fs = kSmem ? shared_workspace<T>()
                : scratch + size_t(blockIdx.x) * tiled_ws(1, ld);
  T* Pbuf = Fs + LL;  // Pf: the current lane's and the next one's
  T* X = Pbuf + 2 * LL;
  T* dinv = X + size_t(ld) * ldx;  // the pivots' reciprocals
  T* part = dinv + ld;
  T* Y = X + ld;                         // F Pf, then Y = Lp⁻¹ F Pf
  T* z = Y + n;                          // mp, then z = Lp⁻¹ mp: a column
  T* Li = X + round_up(ld + n + 1, 4);   // I, then Lp⁻¹
  const Put<T, TM, TN> put{n};
  const bool vec_e = rows_aligned(Eg, n), vec_l = rows_aligned(Lg, n);

  // lane m's Pp, mp and Pf (into P), and F where it is banked, as one
  // cp.async group on the tile; the identity
  const auto stage_lane = [&](int m, T* P) {
    stage<T, kSmem>(X, ldx, pPg + size_t(m) * dd, n);
    stage<T, kSmem>(P, ld, fPg + size_t(m) * dd, n);
    for (int i = tid; i < n; i += NT)
      copy_bytes<kSmem, sizeof(T)>(z + i * ldx, pmg + size_t(m) * n + i);
    if (f_banked) stage<T, kSmem>(Fs, ld, Fg + size_t(m) * dd, n);
    if (kSmem) cp_async_commit();
    for (int idx = tid; idx < n * n; idx += NT) {
      const int i = idx / n, j = idx - i * n;
      Li[i * ldx + j] = i == j ? T(1) : T(0);
    }
  };
  if (!f_banked) stage<T, kSmem>(Fs, ld, Fg, n);  // once for the block
  if (int(blockIdx.x) < M) stage_lane(blockIdx.x, Pbuf);

  int buf = 0;
  for (int m = blockIdx.x; m < M; m += gridDim.x, buf ^= 1) {
    T* Pf = Pbuf + buf * LL;
    if (kSmem) cp_async_wait_all();
    if (tid == 0) s_bad = 0;
    __syncthreads();
    // lower(Pp) into the factor's layout (X holds Pp row-major: X[j·ldx +
    // i] ← Pp[i][j] for i > j), and F Pf into Y
    diag_walk(round_up(n, kWarp), [&](int i, int j) {
      if (i < n && j < i) X[j * ldx + i] = X[i * ldx + j];
    });
    tile_mm<T, NT, TM, TN, false>(Fs, ld, Pf, ld, n, n, n, 0, false,
                                  put.rows(Y, ldx));
    __syncthreads();
    // Lp = chol(Pp) in place; the pivots' reciprocals, NaN throughout
    // unless every pivot is positive
    block_cholesky_panels<T, W>(X, n, &s_bad, ldx);
    const bool bad = s_bad != 0;
    for (int i = tid; i < ld; i += NT)
      dinv[i] = bad ? qnan<T>() : i < n ? T(1) / X[i * ldx + i] : T(1);
    __syncthreads();
    // [Y | z | Lp⁻¹] = Lp⁻¹ [F Pf | mp | I] in place
    block_tri_solve<T, NT, TM, TN, W>(X, dinv, Y, n + 1, Li, n, n, ldx);
    // E = G = Yᵀ Lp⁻¹ (out from registers); L = sym(Pf) − YᵀY in place in
    // Pf: the lower tiles of YᵀY, each thread's tile and its mirror (a
    // diagonal tile averaged with its own transpose), so that L is exactly
    // symmetric; g = mf − Yᵀ z
    tile_mm<T, NT, TM, TN, true>(Y, ldx, Li, ldx, n, n, n, 0, false,
                                 put.out(Eg + size_t(m) * dd, vec_e));
    tile_mm_lower<T, NT, TM>(
        Y, ldx, Y, ldx, n, n, [&](int i0, int j0, const T (&acc)[TM][TM]) {
          T v[TM][TM];
#pragma unroll
          for (int r = 0; r < TM; ++r)
#pragma unroll
            for (int c = 0; c < TM; ++c) {
              const int i = i0 + r, j = j0 + c;
              const T w = i0 == j0 ? T(0.5) * (acc[r][c] + acc[c][r])
                                   : acc[r][c];
              v[r][c] = i < n && j < n
                            ? T(0.5) * (Pf[i * ld + j] + Pf[j * ld + i]) - w
                            : T(0);
            }
#pragma unroll
          for (int r = 0; r < TM; ++r)
#pragma unroll
            for (int c = 0; c < TM; ++c) {
              const int i = i0 + r, j = j0 + c;
              if (i < n && j < n) {
                Pf[i * ld + j] = v[r][c];
                Pf[j * ld + i] = v[r][c];
              }
            }
        });
    mv_cols(Y, ldx, z, n, part,
            [&](int i, T s) {
              gg[size_t(m) * n + i] = fmg[size_t(m) * n + i] - s;
            },
            ldx);
    __syncthreads();
    // the next lane's inputs into the dead regions and the other Pf
    // buffer, landing under the store of L
    const int next = m + int(gridDim.x);
    if (next < M) stage_lane(next, Pbuf + (buf ^ 1) * LL);
    copy_out(Lg + size_t(m) * dd, Pf, ld, n, vec_l);
  }
}

// The tiled kernel for (tile, threads), or null where none is built: tiles
// 0 (global scratch) and kTile at 256 threads; K10b also kTile at 512
// threads in float32 (ops/bank_combine.py block_threads). K11b's
// block_smoother_elements_kernel takes the same two routes.
template <typename T>
auto combine_kernel_for(int tile, int threads)
    -> decltype(&tiled_combine_kernel<T, 0, kBlockThreads>) {
  if (threads == kBlockThreads && tile == 0)
    return tiled_combine_kernel<T, 0, kBlockThreads>;
  if (threads == kBlockThreads && tile == kTile)
    return tiled_combine_kernel<T, kTile, kBlockThreads>;
  if constexpr (sizeof(T) == 4)
    if (threads == 512 && tile == kTile)
      return tiled_combine_kernel<T, kTile, 512>;
  return nullptr;
}

template <typename T>
auto scombine_kernel_for(int tile, int threads)
    -> decltype(&tiled_smoother_combine_kernel<T, 0, kBlockThreads>) {
  if (threads == kBlockThreads && tile == 0)
    return tiled_smoother_combine_kernel<T, 0, kBlockThreads>;
  if (threads == kBlockThreads && tile == kTile)
    return tiled_smoother_combine_kernel<T, kTile, kBlockThreads>;
  return nullptr;
}

template <typename T>
auto elements_kernel_for(int tile, int threads)
    -> decltype(&block_smoother_elements_kernel<T, 0, kBlockThreads>) {
  if (threads == kBlockThreads && tile == 0)
    return block_smoother_elements_kernel<T, 0, kBlockThreads>;
  if (threads == kBlockThreads && tile == kTile)
    return block_smoother_elements_kernel<T, kTile, kBlockThreads>;
  return nullptr;
}

// Launch a tiled kernel of workspace kind 0 (K10b), 1 (K11b) or 2 (K12b)
// over M lanes: with tile > 0 a persistent grid of as many blocks as the SMs hold
// at once, the workspace in dynamic shared memory; with tile 0
// kScratchBlocksPerSM blocks an SM (at most M), each on its slice of the
// caller's scratch (bft_block_scratch_elems).
template <typename T, typename K, typename... Args>
int launch_tiled(K kernel, int kind, int tile, int threads, void* scratch,
                 int M, int n, void* stream, Args... args) {
  int dev = 0, sms = 0, grid = 0;
  size_t smem = 0;
  if (kernel == nullptr || n < 1 || (tile != 0 && tile < n) ||
      (tile == 0) != (scratch != nullptr) ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return int(cudaErrorInvalidValue);
  if (tile) {
    int per_sm = 0;
    smem = tiled_ws(kind, tile) * sizeof(T);
    const int err = set_smem(kernel, smem);
    if (err != 0) return err;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, threads, smem) != cudaSuccess ||
        per_sm < 1)
      return int(cudaErrorInvalidConfiguration);
    grid = std::min(M, per_sm * sms);
  } else {
    grid = std::min(M, kScratchBlocksPerSM * sms);
  }
  kernel<<<grid, threads, smem, cudaStream_t(stream)>>>(
      args..., static_cast<T*>(scratch));
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

#define BFT_COMBINE_ENTRY(NAME, T)                                           \
  int NAME(const void* A1, const void* b1, const void* C1, const void* J1,   \
           const void* e1, const void* A2, const void* b2, const void* C2,   \
           const void* J2, const void* e2, void* A, void* b, void* C,        \
           void* J, void* e, int M, int Ml, int Mr, int dx, void* stream) {  \
    const void* in[10] = {A1, b1, C1, J1, e1, A2, b2, C2, J2, e2};           \
    void* out[5] = {A, b, C, J, e};                                          \
    return launch_combine<T>(in, out, M, Ml, Mr, dx, stream);                \
  }
BFT_COMBINE_ENTRY(bft_bank_combine_f32, float)
BFT_COMBINE_ENTRY(bft_bank_combine_f64, double)
#undef BFT_COMBINE_ENTRY

int bft_bank_smoother_elements_f32(const void* fm, const void* fP,
                                   const void* pm, const void* pP,
                                   const void* F, void* E, void* g, void* L,
                                   int M, int f_banked, int dx,
                                   void* stream) {
  return launch_elements<float>(fm, fP, pm, pP, F, E, g, L, M, f_banked, dx,
                                stream);
}

int bft_bank_smoother_elements_f64(const void* fm, const void* fP,
                                   const void* pm, const void* pP,
                                   const void* F, void* E, void* g, void* L,
                                   int M, int f_banked, int dx,
                                   void* stream) {
  return launch_elements<double>(fm, fP, pm, pP, F, E, g, L, M, f_banked, dx,
                                 stream);
}

int bft_bank_smoother_combine_f32(const void* E1, const void* g1,
                                  const void* L1, const void* E2,
                                  const void* g2, const void* L2, void* E,
                                  void* g, void* L, int M, int Ml, int Mr,
                                  int dx, void* stream) {
  return launch_scombine<float>(E1, g1, L1, E2, g2, L2, E, g, L, M, Ml, Mr,
                                dx, stream);
}

int bft_bank_smoother_combine_f64(const void* E1, const void* g1,
                                  const void* L1, const void* E2,
                                  const void* g2, const void* L2, void* E,
                                  void* g, void* L, int M, int Ml, int Mr,
                                  int dx, void* stream) {
  return launch_scombine<double>(E1, g1, L1, E2, g2, L2, E, g, L, M, Ml, Mr,
                                 dx, stream);
}

// The global scratch, in elements, of a block kernel of workspace kind 0
// (K10b), 1 (K11b) or 2 (K12b) over M lanes on its global route (tile 0),
// which the caller takes where the tiles do not fit. -1 on a failed device
// query.
long long bft_block_scratch_elems(int kind, int M, int dx, int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess)
    return -1;
  return (long long)std::min(M, kScratchBlocksPerSM * sms) *
         (long long)tiled_ws(kind, tiled_ld(0, dx));
}

#define BFT_BLOCK_COMBINE_ENTRY(NAME, T)                                     \
  int NAME(const void* A1, const void* b1, const void* C1, const void* J1,   \
           const void* e1, const void* A2, const void* b2, const void* C2,   \
           const void* J2, const void* e2, void* A, void* b, void* C,        \
           void* J, void* e, void* scratch, int M, int Ml, int Mr, int dx,   \
           int tile, int threads, void* stream) {                            \
    using P = const T*;                                                      \
    return launch_tiled<T>(combine_kernel_for<T>(tile, threads), 0, tile,    \
                           threads, scratch, M, dx, stream, P(A1), P(b1),    \
                           P(C1), P(J1), P(e1), P(A2), P(b2), P(C2), P(J2),  \
                           P(e2), (T*)A, (T*)b, (T*)C, (T*)J, (T*)e, M, Ml,  \
                           Mr, dx);                                          \
  }
BFT_BLOCK_COMBINE_ENTRY(bft_block_combine_f32, float)
BFT_BLOCK_COMBINE_ENTRY(bft_block_combine_f64, double)
#undef BFT_BLOCK_COMBINE_ENTRY

#define BFT_BLOCK_ELEMENTS_ENTRY(NAME, T)                                    \
  int NAME(const void* fm, const void* fP, const void* pm, const void* pP,   \
           const void* F, void* E, void* g, void* L, void* scratch, int M,   \
           int f_banked, int dx, int tile, int threads, void* stream) {      \
    using P = const T*;                                                      \
    return launch_tiled<T>(elements_kernel_for<T>(tile, threads), 1, tile,   \
                           threads, scratch, M, dx, stream, P(fm), P(fP),    \
                           P(pm), P(pP), P(F), (T*)E, (T*)g, (T*)L, M,       \
                           f_banked, dx);                                    \
  }
BFT_BLOCK_ELEMENTS_ENTRY(bft_block_smoother_elements_f32, float)
BFT_BLOCK_ELEMENTS_ENTRY(bft_block_smoother_elements_f64, double)
#undef BFT_BLOCK_ELEMENTS_ENTRY

#define BFT_BLOCK_SCOMBINE_ENTRY(NAME, T)                                    \
  int NAME(const void* E1, const void* g1, const void* L1, const void* E2,   \
           const void* g2, const void* L2, void* E, void* g, void* L,        \
           void* scratch, int M, int Ml, int Mr, int dx, int tile,           \
           int threads, void* stream) {                                      \
    using P = const T*;                                                      \
    return launch_tiled<T>(scombine_kernel_for<T>(tile, threads), 2, tile,   \
                           threads, scratch, M, dx, stream, P(E1), P(g1),    \
                           P(L1), P(E2), P(g2), P(L2), (T*)E, (T*)g, (T*)L,  \
                           M, Ml, Mr, dx);                                   \
  }
BFT_BLOCK_SCOMBINE_ENTRY(bft_block_smoother_combine_f32, float)
BFT_BLOCK_SCOMBINE_ENTRY(bft_block_smoother_combine_f64, double)
#undef BFT_BLOCK_SCOMBINE_ENTRY

}  // extern "C"
