// Banded anti-diagonal DP fill for NVIDIA Hopper (sm_90a), called from JAX
// through the XLA FFI (bioinfo1_tpu/ops/band.py loads and registers it).
//
// One thread block fills one read's band.  Lane l of anti-diagonal d holds
// the cell i = (d + W)/2 - l, j = d - i (diagonal offset o = j - i =
// 2l - W + (d & 1)), the layout of the lax twin
// (ops/align.align_banded_parents), which this kernel matches bit for bit:
// scores, goal cells and the 2-bit parents packed 16 lanes per uint32 in
// (S, B, W/16) with diagonal d at row d - 2.
//
// The block owns the whole diagonal loop: the three live diagonals sit in
// a ring of three W-wide rows (shared memory, or a global scratch row for
// bands too wide for it), so one barrier per diagonal orders every read of
// diagonal d-1/d-2 before the row is recycled for d+1.  Query and target
// bytes are read per cell from the read's own rows (cached loads); there is
// no per-diagonal kernel launch and no host round trip.
//
// Goal tracking follows the reference's scan-order tie rules
// (team_alignment.cpp:185-192, 265-278): each thread keeps its own best
// under the same total order, and thread 0 reduces them at the end.

#include <cstdint>
#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kNeg = -(1 << 30);  // invalid-cell fill; safe against +gap
constexpr int kDash = 45;         // '-' costs no gap (team_alignment.cpp:25-28)
constexpr int kMaxThreads = 1024;
constexpr int kSmemLimit = 227 * 1024;

template <int MODE, bool PARENTS, bool DASH_FREE>
__global__ void __launch_bounds__(kMaxThreads)
band_fill_kernel(const uint8_t* __restrict__ q, const int32_t* __restrict__ q_lens,
                 const uint8_t* __restrict__ t, const int32_t* __restrict__ t_lens,
                 const int32_t* __restrict__ prm, int32_t* __restrict__ score_out,
                 int32_t* __restrict__ gi_out, int32_t* __restrict__ gj_out,
                 uint32_t* __restrict__ parents, int32_t* __restrict__ scratch,
                 int B, int n, int m, int m_eff, int W, bool rows_in_smem) {
  extern __shared__ int32_t smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int K = (W + T - 1) / T;
  int32_t* rows = rows_in_smem ? smem : scratch + (size_t)b * 3 * W;
  int32_t* red = rows_in_smem ? smem + 3 * W : smem;
  const uint8_t* qr = q + (size_t)b * n;
  const uint8_t* tr = t + (size_t)b * m;
  const int match = prm[0], mismatch = prm[1], gap = prm[2];
  const int init = MODE == 0 ? gap : 0;
  const int ql = q_lens[b];
  const int tl = min(t_lens[b], m_eff);
  const int half = W / 2;
  const int PW = W / 16;

  // d = 0: cell (0,0) at lane W/2.  d = 1: (0,1) at W/2 and (1,0) at W/2-1.
  for (int l = tid; l < W; l += T) {
    rows[l] = l == half ? 0 : kNeg;
    rows[W + l] = (l == half || l == half - 1) ? init : kNeg;
  }
  __syncthreads();

  // Every goal rule reads only cells with d <= ql + tl; parents are written
  // for every diagonal so the tensor matches the lax twin's exactly.
  const int d_last = n + m_eff;
  const int d_end = PARENTS ? d_last : min(ql + tl, d_last);

  int g_val = 0;                        // global: goal value (0 off band)
  int bv = kNeg, bi = 0, bj = 0;        // local: best (value, i, j)
  int cc = 0, ci = 0, rc = 0, rj = 0;   // semiGlobal: last column / row

  for (int d = 2; d <= d_end; ++d) {
    const int p = d & 1;
    const int i0 = (d + W) >> 1;
    int32_t* cur = rows + (d % 3) * W;
    const int32_t* h1 = rows + ((d + 2) % 3) * W;  // diagonal d-1
    const int32_t* h2 = rows + ((d + 1) % 3) * W;  // diagonal d-2
    for (int k = 0; k < K; ++k) {
      const int l = tid + k * T;
      uint32_t par = 0;
      if (l < W) {
        const int i = i0 - l;
        const int j = d - i;
        const int qb = i >= 1 ? qr[min(i - 1, n - 1)] : 0;
        const int tb = j >= 1 ? tr[min(j - 1, m_eff - 1)] : 0;
        const int diag_v = h2[l] + (qb == tb ? match : mismatch);
        int up, left;
        if (p == 0) {
          up = h1[l];
          left = l > 0 ? h1[l - 1] : kNeg;
        } else {
          up = l + 1 < W ? h1[l + 1] : kNeg;
          left = h1[l];
        }
        int h;
        if (PARENTS) {
          // M > I > D first-set / strictly-greater (team_alignment.cpp:104-114).
          const int left_v = left + ((DASH_FREE || tb != kDash) ? gap : 0);
          const int up_v = up + ((DASH_FREE || qb != kDash) ? gap : 0);
          h = diag_v;
          if (left_v > diag_v) { h = left_v; par = 1; }
          if (up_v > h) { h = up_v; par = 2; }
        } else if (DASH_FREE) {
          h = __viaddmax_s32(max(left, up), gap, diag_v);
        } else {
          h = __vimax3_s32(diag_v, left + (tb == kDash ? 0 : gap),
                           up + (qb == kDash ? 0 : gap));
        }
        if (MODE == 1) h = max(h, 0);
        if (i == 0) h = j * init;
        if (j == 0) h = i * init;
        if (i < 0 || j < 0) h = kNeg;
        cur[l] = h;

        if (MODE == 0) {
          if (d == ql + tl && l == ((tl - ql + W - p) >> 1)) g_val = h;
        } else if (MODE == 1) {
          if (i >= 1 && i <= ql && j >= 1 && j <= tl &&
              (h > bv || (h == bv && (i < bi || (i == bi && j < bj))))) {
            bv = h; bi = i; bj = j;
          }
        } else {
          if (j == tl && i <= ql && i >= 0 && h > cc) { cc = h; ci = i; }
          if (i == ql && j <= tl && j >= 0 && h > rc) { rc = h; rj = j; }
        }
      }
      if (PARENTS) {
        // 16 lanes per word: T is a multiple of 32, so l & 15 == tid & 15
        // and each half-warp holds one word's lanes.
        uint32_t word = par << (2 * (l & 15));
        word |= __shfl_xor_sync(0xffffffffu, word, 1);
        word |= __shfl_xor_sync(0xffffffffu, word, 2);
        word |= __shfl_xor_sync(0xffffffffu, word, 4);
        word |= __shfl_xor_sync(0xffffffffu, word, 8);
        if (l < W && (l & 15) == 0)
          parents[((size_t)(d - 2) * B + b) * PW + (l >> 4)] = word;
      }
    }
    __syncthreads();
  }

  red[4 * tid + 0] = MODE == 0 ? g_val : MODE == 1 ? bv : cc;
  red[4 * tid + 1] = MODE == 1 ? bi : ci;
  red[4 * tid + 2] = MODE == 1 ? bj : rc;
  red[4 * tid + 3] = rj;
  __syncthreads();
  if (tid != 0) return;
  if (MODE == 0) {
    // Exactly one lane of one diagonal can hold the goal; every other
    // thread kept 0, so the sum is the goal value (or 0 off band).
    int s = 0;
    for (int x = 0; x < T; ++x) s += red[4 * x];
    score_out[b] = s;
    gi_out[b] = ql;
    gj_out[b] = tl;
  } else if (MODE == 1) {
    int v = kNeg, a = 0, c = 0;
    for (int x = 0; x < T; ++x) {
      const int xv = red[4 * x], xa = red[4 * x + 1], xc = red[4 * x + 2];
      if (xv > v || (xv == v && (xa < a || (xa == a && xc < c)))) {
        v = xv; a = xa; c = xc;
      }
    }
    const bool hit = v > kNeg;
    score_out[b] = hit ? v : 0;
    gi_out[b] = hit ? a : 0;
    gj_out[b] = hit ? c : 0;
  } else {
    int c_v = 0, c_i = 0, r_v = 0, r_j = 0;
    for (int x = 0; x < T; ++x) {
      const int xv = red[4 * x], xi = red[4 * x + 1];
      if (xv > c_v || (xv == c_v && xv > 0 && xi < c_i)) { c_v = xv; c_i = xi; }
      const int yv = red[4 * x + 2], yj = red[4 * x + 3];
      if (yv > r_v || (yv == r_v && yv > 0 && yj < r_j)) { r_v = yv; r_j = yj; }
    }
    const bool row_wins = r_v > c_v;
    score_out[b] = row_wins ? r_v : c_v;
    gi_out[b] = row_wins ? ql : c_i;
    gj_out[b] = row_wins ? r_j : tl;
  }
}

using KernelFn = void (*)(const uint8_t*, const int32_t*, const uint8_t*,
                          const int32_t*, const int32_t*, int32_t*, int32_t*,
                          int32_t*, uint32_t*, int32_t*, int, int, int, int,
                          int, bool);

template <int MODE>
KernelFn pick(bool parents, bool dash_free) {
  if (parents)
    return dash_free ? band_fill_kernel<MODE, true, true>
                     : band_fill_kernel<MODE, true, false>;
  return dash_free ? band_fill_kernel<MODE, false, true>
                   : band_fill_kernel<MODE, false, false>;
}

}  // namespace

// Threads per block and whether the three band rows fit shared memory; the
// Python wrapper sizes the scratch result with the same rule
// (ops/band.py _launch_shape).
static void launch_shape(int W, int* threads, bool* rows_in_smem, int* smem) {
  *threads = W < kMaxThreads ? W : kMaxThreads;
  const int red = 16 * *threads;
  *rows_in_smem = 12 * W + red <= kSmemLimit;
  *smem = (*rows_in_smem ? 12 * W : 0) + red;
}

static ffi::Error BandFillImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> q,
                               ffi::Buffer<ffi::S32> q_lens,
                               ffi::Buffer<ffi::U8> t,
                               ffi::Buffer<ffi::S32> t_lens,
                               ffi::Buffer<ffi::S32> prm,
                               ffi::ResultBuffer<ffi::S32> score,
                               ffi::ResultBuffer<ffi::S32> goal_i,
                               ffi::ResultBuffer<ffi::S32> goal_j,
                               ffi::ResultBuffer<ffi::U32> parents,
                               ffi::ResultBuffer<ffi::S32> scratch,
                               int32_t W, int32_t mode, bool want_parents,
                               bool dash_free, int32_t m_eff) {
  const auto qd = q.dimensions();
  const auto td = t.dimensions();
  if (qd.size() != 2 || td.size() != 2 || qd[0] != td[0])
    return ffi::Error::InvalidArgument("q/t must be (B, n)/(B, m)");
  if (W < 32 || W % 32 != 0)
    return ffi::Error::InvalidArgument("band width must be a multiple of 32");
  const int B = static_cast<int>(qd[0]);
  const int n = static_cast<int>(qd[1]);
  const int m = static_cast<int>(td[1]);
  if (B == 0) return ffi::Error::Success();
  int threads, smem;
  bool rows_in_smem;
  launch_shape(W, &threads, &rows_in_smem, &smem);
  KernelFn fn = mode == 0   ? pick<0>(want_parents, dash_free)
                : mode == 1 ? pick<1>(want_parents, dash_free)
                            : pick<2>(want_parents, dash_free);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err != cudaSuccess)
    return ffi::Error::Internal(cudaGetErrorString(err));
  fn<<<B, threads, smem, stream>>>(
      q.typed_data(), q_lens.typed_data(), t.typed_data(), t_lens.typed_data(),
      prm.typed_data(), score->typed_data(), goal_i->typed_data(),
      goal_j->typed_data(), parents->typed_data(), scratch->typed_data(), B,
      n, m, m_eff, W, rows_in_smem);
  err = cudaGetLastError();
  if (err != cudaSuccess)
    return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

XLA_FFI_DEFINE_HANDLER_SYMBOL(Bioinfo1BandFill, BandFillImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Attr<int32_t>("W")
                                  .Attr<int32_t>("mode")
                                  .Attr<bool>("want_parents")
                                  .Attr<bool>("dash_free")
                                  .Attr<int32_t>("m_eff"));
