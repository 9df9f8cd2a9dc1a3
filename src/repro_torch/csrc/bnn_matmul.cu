// BNN sign products and their SignSTE backward, for Hopper (sm_90a).
//
// Replaces four Pallas kernels of src/repro/kernels/bnn_matmul.py:
//   bnn_matmul_kernel_call         (kernel 6)  y  = sign(x) @ sign(w)
//   bnn_packed_matmul_kernel_call  (kernel 7)  y  = sign(x) @ unpack(wp)
//   bnn_bwd_dx_call                (kernel 8)  dx = (g @ sign(w)^T) * 1[|x| <= 1]
//   bnn_bwd_dw_call                (kernel 9)  dw = (sign(x)^T @ g) * 1[|w| <= 1]
// with sign(v) = (v >= 0 ? +1 : -1): +0 and -0 give +1, NaN gives -1. Every
// sign bit is formed as `v >= 0`, never from the float's sign bit (which
// would send -0 to -1). The hard-tanh windows are inclusive.
//
// Operands: x float32 (M, K); w float32 (K, N) in training, int8 +-1 (K, N)
// for the unpacked serve form, or uint8 bitplanes wp (K/8, N) for the
// packed serve form (bit j of byte r of column n is row 8r + j, 1 -> +1);
// g float32 (M, N). All row-major and contiguous.
//
// Forward (kernels 6 and 7: one template, three weight kinds). The work is
// exact integer counting, done as the paper's BNN PE does it (XNOR +
// popcount, src/repro/core/bnn.py): with the signs of 32 consecutive K rows
// packed into one word on each side, a word pair contributes
// 32 - 2 * popc(xbits ^ wbits) to the dot product. A block computes a BM x
// 64 tile of y (BM = 64, or 16 when M <= 16 as in decode) and walks its K
// range in stages of 4 words (128 rows):
//   - x: a warp reads 32 consecutive x of one row and __ballot_sync(x >= 0)
//     is the word;
//   - w: a thread builds the word of one column from 32 rows of w in the
//     dtype it is stored in (float32 or int8, no cast pass), or from the 4
//     bytes of wp that hold those rows (the 4 bytes lie N bytes apart);
//   - each thread then XORs and popcounts its RM x 4 register tile.
// Rows at or past the end of the block's K range give 0 bits on both
// sides, so they count as agreements and add nothing to the mismatch count;
// the result over a range of length L is L - 2 * mismatches, and no
// padding constant (the reference's +-1 per padded row) is needed. At the
// decode shapes the (M, N) tiles are too few to fill the card, so K is
// split over gridDim.z and the partial sums meet through atomicAdd into a
// zeroed output: every partial and total is an integer of magnitude
// <= K < 2^24, exact in float32, so the result is exact and deterministic
// in any order. With one split a block stores its tile directly.
//
// What bounds the forward on the H100: bytes. At decode (M = 4) it is the
// weight read (1 bit per weight packed, 1 byte unpacked int8); at the
// training shape (512, 960, 2560) the 2 M K N sign products are exact on the
// tensor cores, whose rate puts them under the 17 MB of float operands. The
// popcount form needs 1/32 of an integer instruction per product, so the
// CUDA cores are not the limit either; the block re-reads its w slab once
// per M tile (from L2).
//
// Backward (kernels 8 and 9: one template, two instantiations). Each is a
// float32 product with +-1 on one side: dx contracts N, dw contracts M. A
// block owns a BR x 64 tile of its output (BR = 64, or 32 when the 64-row
// tiles are fewer than the card's 132 SMs, as at dx (512, 960) and dw
// (960, 320)), walks its contraction axis in steps of 32 with both operand
// slices staged in shared memory (the +-1 side formed as it is staged), and
// accumulates a 4 x 4 register tile with fmaf(+-1, g, part), which is an
// exact product and one rounded add. Each stage of 32 steps sums into its
// own partial, which is then added to the running total: over the dx
// contraction N = 2560 (g ~ N(0, 1)) one running sum drifts past the
// reference's 1e-4 bound at some elements, two levels stay well inside it.
// The hard-tanh mask depends only on the
// output's own operand, so it is applied once, as the tile is written. No
// split of the contraction axis and no atomics: each output element is one
// thread's sum in a fixed order, so both kernels are deterministic. They
// differ from plain PyTorch only by summation order (float32
// reassociation). What bounds them: operations, 2 M K N float32 on the CUDA
// cores (the reference's fp32 result within 1e-4 needs fp32 sums).
//
// Ragged M, N and K are masked here (zero-filled loads, guarded stores);
// nothing is padded. No --use_fast_math.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int FWD_THREADS = 256;
constexpr int FWD_BN = 64;         // output columns per forward block
constexpr int SW = 4;              // 32-row words per forward stage
constexpr int STAGE_K = 32 * SW;   // K rows per forward stage
constexpr int BWD_BC = 64;         // output columns per backward block
constexpr int BWD_TT = 32;         // contraction steps per backward stage
constexpr int NUM_SMS = 132;
constexpr int TARGET_BLOCKS = 2 * NUM_SMS;

enum WeightKind { W_F32 = 0, W_I8 = 1, W_PACKED = 2 };

int cdiv(int a, int b) { return (a + b - 1) / b; }

// The sign word of rows 32q..32q+31 of column n: bit j set where row 32q + j
// has sign +1. Rows at or past k_end give 0 (for the packed kind, k_end is a
// multiple of 8, so whole bytes are kept or dropped). Every load reads a
// valid address (the row index is clamped to K - 1) and the bound is
// applied to the bit, so no load waits behind a branch.
template <int KIND>
__device__ __forceinline__ uint32_t weight_word(const void* __restrict__ w, int q, int n,
                                                int N, int K, int k_end) {
  uint32_t word = 0;
  if constexpr (KIND == W_PACKED) {
    const uint8_t* wp = static_cast<const uint8_t*>(w);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int r = 4 * q + b;  // byte row r holds K rows 8r..8r+7
      const uint32_t byte = wp[(size_t)min(r, K / 8 - 1) * N + n];
      word |= (8 * r < k_end ? byte : 0u) << (8 * b);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int k = 32 * q + j;
      const size_t at = (size_t)min(k, K - 1) * N + n;
      const bool pos = KIND == W_F32 ? static_cast<const float*>(w)[at] >= 0.f
                                     : static_cast<const int8_t*>(w)[at] >= 0;
      word |= (uint32_t)(pos && k < k_end) << j;
    }
  }
  return word;
}

template <int KIND, int BM>
__global__ void __launch_bounds__(FWD_THREADS)
bnn_fwd_kernel(const float* __restrict__ x, const void* __restrict__ w, float* __restrict__ y,
               int M, int N, int K, int k_per_split) {
  constexpr int RM = BM / 16;  // output rows per thread: ty + 16 i
  constexpr int WARPS = FWD_THREADS / 32;
  constexpr int X_PER_WARP = BM * SW / WARPS;  // x words each warp forms per stage
  static_assert(BM % 16 == 0 && BM * SW % WARPS == 0, "tile shape");
  __shared__ uint32_t xb[BM][SW];
  __shared__ uint32_t wb[SW][FWD_BN];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ty = tid / 16, tx = tid % 16;  // columns tx + 16 j
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * FWD_BN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  int mism[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) mism[i][j] = 0;

  for (int kc = k_begin; kc < k_end; kc += STAGE_K) {
    __syncthreads();
    // x: one ballot per (row, word), lane j reading x[m, 32q + j]. All of
    // a warp's loads (at clamped, valid addresses) go out before its
    // first ballot, so their latencies overlap; every lane runs every
    // ballot, as __ballot_sync needs.
    bool pos[X_PER_WARP];
#pragma unroll
    for (int i = 0; i < X_PER_WARP; ++i) {
      const int e = warp + WARPS * i, r = e / SW, s = e % SW;
      const int m = m0 + r, k = kc + 32 * s + lane;
      const float v = x[(size_t)min(m, M - 1) * K + min(k, K - 1)];
      pos[i] = m < M && k < k_end && v >= 0.f;
    }
#pragma unroll
    for (int i = 0; i < X_PER_WARP; ++i) {
      const int e = warp + WARPS * i;
      const uint32_t word = __ballot_sync(0xffffffffu, pos[i]);
      if (lane == 0) xb[e / SW][e % SW] = word;
    }
    // w: one thread per (word, column), neighbouring threads on n
    for (int e = tid; e < SW * FWD_BN; e += FWD_THREADS) {
      const int s = e / FWD_BN, c = e % FWD_BN;
      const int n = n0 + c;
      wb[s][c] = n < N ? weight_word<KIND>(w, kc / 32 + s, n, N, K, k_end) : 0u;
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < SW; ++s) {
      uint32_t xv[RM], wv[4];
#pragma unroll
      for (int i = 0; i < RM; ++i) xv[i] = xb[ty + 16 * i][s];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = wb[s][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mism[i][j] += __popc(xv[i] ^ wv[j]);
    }
  }
  const int len = k_end - k_begin;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int m = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (m < M && n < N) {
        const float v = (float)(len - 2 * mism[i][j]);
        if (gridDim.z == 1)
          y[(size_t)m * N + n] = v;
        else
          atomicAdd(&y[(size_t)m * N + n], v);
      }
    }
  }
}

__device__ __forceinline__ float sgn(float v) { return v >= 0.f ? 1.f : -1.f; }

// out[r][c] = mask(r, c) * sum_t A[t][r] * B[t][c] over a BR x 64 tile:
//   DX: out = dx (M, K): r = m, c = k, t = n; A = g[m, n], B = sign(w[k, n]),
//       mask = 1[|x[m, k]| <= 1]
//   DW: out = dw (K, N): r = k, c = n, t = m; A = sign(x[m, k]), B = g[m, n],
//       mask = 1[|w[k, n]| <= 1]
// (BR / 4) x 16 threads, each a 4 x 4 tile: rows 4 ty + i, columns 4 tx + j.
template <bool DX, int BR>
__global__ void __launch_bounds__(BR * 4)
bnn_bwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ g, float* __restrict__ out, int M, int N, int K) {
  constexpr int THREADS = BR * 4;
  __shared__ __align__(16) float as[BWD_TT][BR + 4];
  __shared__ __align__(16) float bs[BWD_TT][BWD_BC + 4];
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int R = DX ? M : K, C = DX ? K : N, T = DX ? N : M;
  const int r0 = blockIdx.y * BR, c0 = blockIdx.x * BWD_BC;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int t0 = 0; t0 < T; t0 += BWD_TT) {
    __syncthreads();
    if (DX) {
      // g and w are both contiguous along n = t: neighbouring threads on t
      for (int e = tid; e < BWD_TT * BR; e += THREADS) {
        const int r = e / BWD_TT, t = e % BWD_TT;
        const int m = r0 + r, n = t0 + t;
        as[t][r] = (m < M && n < N) ? g[(size_t)m * N + n] : 0.f;
      }
      for (int e = tid; e < BWD_TT * BWD_BC; e += THREADS) {
        const int c = e / BWD_TT, t = e % BWD_TT;
        const int k = c0 + c, n = t0 + t;
        bs[t][c] = (k < K && n < N) ? sgn(w[(size_t)k * N + n]) : 0.f;
      }
    } else {
      // x is contiguous along k = r, g along n = c
      for (int e = tid; e < BWD_TT * BR; e += THREADS) {
        const int t = e / BR, r = e % BR;
        const int m = t0 + t, k = r0 + r;
        as[t][r] = (m < M && k < K) ? sgn(x[(size_t)m * K + k]) : 0.f;
      }
      for (int e = tid; e < BWD_TT * BWD_BC; e += THREADS) {
        const int t = e / BWD_BC, c = e % BWD_BC;
        const int m = t0 + t, n = c0 + c;
        bs[t][c] = (m < M && n < N) ? g[(size_t)m * N + n] : 0.f;
      }
    }
    __syncthreads();
    float part[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = 0.f;
#pragma unroll 8
    for (int t = 0; t < BWD_TT; ++t) {
      const float4 a = *reinterpret_cast<const float4*>(&as[t][4 * ty]);
      const float4 b = *reinterpret_cast<const float4*>(&bs[t][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = fmaf(av[i], bv[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * ty + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + 4 * tx + j;
      if (r < R && c < C) {
        const float own = DX ? x[(size_t)r * K + c] : w[(size_t)r * N + c];
        out[(size_t)r * C + c] = fabsf(own) <= 1.f ? acc[i][j] : 0.f;
      }
    }
  }
}

template <int KIND>
void launch_fwd(const float* x, const void* w, float* y, int M, int N, int K, bool small,
                dim3 grid, int k_per_split, cudaStream_t st) {
  if (small)
    bnn_fwd_kernel<KIND, 16><<<grid, FWD_THREADS, 0, st>>>(x, w, y, M, N, K, k_per_split);
  else
    bnn_fwd_kernel<KIND, 64><<<grid, FWD_THREADS, 0, st>>>(x, w, y, M, N, K, k_per_split);
}

}  // namespace

// Kernels 6 and 7. x float32 (M, K); w by w_kind: 0 float32 (K, N), 1 int8
// (K, N), 2 uint8 bitplanes (K/8, N) with K % 8 == 0 -> y float32 (M, N),
// exact integer sums. Launches on `stream`, does not synchronise, returns
// cudaGetLastError() (or the memset's error).
extern "C" int bnn_fwd_launch(const void* x, const void* w, void* y, int M, int N, int K,
                              int w_kind, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // float32 holds every count exactly only while |y| <= K < 2^24
  if (M <= 0 || N <= 0 || K <= 0 || K >= (1 << 24) || w_kind < W_F32 || w_kind > W_PACKED ||
      (w_kind == W_PACKED && K % 8))
    return (int)cudaErrorInvalidValue;
  const bool small = M <= 16;
  const int gn = cdiv(N, FWD_BN), gm = cdiv(M, small ? 16 : 64);
  // split K (in whole stages) until the blocks reach TARGET_BLOCKS
  int parts = std::min(std::max(1, cdiv(TARGET_BLOCKS, gn * gm)), cdiv(K, STAGE_K));
  const int k_per_split = cdiv(cdiv(K, parts), STAGE_K) * STAGE_K;
  parts = cdiv(K, k_per_split);
  if (parts > 1) {
    cudaError_t err = cudaMemsetAsync(y, 0, (size_t)M * N * sizeof(float), st);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(gn, gm, parts);
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  if (w_kind == W_F32)
    launch_fwd<W_F32>(xf, w, yf, M, N, K, small, grid, k_per_split, st);
  else if (w_kind == W_I8)
    launch_fwd<W_I8>(xf, w, yf, M, N, K, small, grid, k_per_split, st);
  else
    launch_fwd<W_PACKED>(xf, w, yf, M, N, K, small, grid, k_per_split, st);
  return (int)cudaGetLastError();
}

// Kernels 8 (want_dx != 0: out = dx (M, K)) and 9 (want_dx == 0: out = dw
// (K, N)). x (M, K), w (K, N), g (M, N), all float32. Writes every element
// of `out`, launches on `stream`, does not synchronise, returns
// cudaGetLastError().
extern "C" int bnn_bwd_launch(const void* x, const void* w, const void* g, void* out,
                              int M, int N, int K, int want_dx, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const int rows = want_dx ? M : K, cols = want_dx ? K : N;
  const int gc = cdiv(cols, BWD_BC);
  const bool narrow = cdiv(rows, 64) * gc < NUM_SMS;  // 64-row tiles would leave SMs idle
  const dim3 grid(gc, cdiv(rows, narrow ? 32 : 64));
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* gf = static_cast<const float*>(g);
  float* of = static_cast<float*>(out);
  if (want_dx) {
    if (narrow)
      bnn_bwd_kernel<true, 32><<<grid, 32 * 4, 0, st>>>(xf, wf, gf, of, M, N, K);
    else
      bnn_bwd_kernel<true, 64><<<grid, 64 * 4, 0, st>>>(xf, wf, gf, of, M, N, K);
  } else {
    if (narrow)
      bnn_bwd_kernel<false, 32><<<grid, 32 * 4, 0, st>>>(xf, wf, gf, of, M, N, K);
    else
      bnn_bwd_kernel<false, 64><<<grid, 64 * 4, 0, st>>>(xf, wf, gf, of, M, N, K);
  }
  return (int)cudaGetLastError();
}
