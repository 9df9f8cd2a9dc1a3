// Training-form BiKA comparator-accumulate (CAC) and its STE backward, for
// Hopper (sm_90a).
//
// Replaces four Pallas kernels of src/repro/kernels/cac_matmul.py:
//   cac_train_fwd_call        (kernel 2)  y  = sum_k Sign(x w + beta)
//   cac_train_bwd_dx_call     (kernel 3)  dx = sum_n g mask w
//   cac_train_bwd_dw_call     (kernel 4)  dw = sum_m g mask x, dbeta = sum_m g mask
//   cac_train_bwd_fused_call  (kernel 5)  all three from one mask recompute
// with  pre = x[m,k] * w[k,n] + beta[k,n],  Sign(0) = +1,
//       mask = 1[|pre| <= 1]  (the hard-tanh STE window, inclusive).
// All operands float32: x (M, K), w and beta (K, N), g (M, N).
//
// Rounding: every kernel forms the pre-activation as
// __fadd_rn(__fmul_rn(x, w), beta), a rounded product and then a rounded
// sum, never one fused multiply-add. Plain PyTorch rounds the same way, so
// Sign and the STE mask agree with it element for element (nvcc would
// otherwise contract x*w + beta into an fma, and an element within an ulp
// of 0 or of +-1 would take the other side). No --use_fast_math.
//
// What bounds them on the H100: there is no tensor-core form of a
// compare-select, so the work is on the CUDA cores: about 4 operations per
// (m, k, n) in the forward (mul, add, compare, count) and about 9 in the
// backward (mul, add, abs-compare, select, and three multiply-adds). At the
// training path's M = 512 both are bound by operations (the forward at
// (512, 960, 2560) ~75 us at 67 TFLOP/s against ~6 us of bytes), so the
// design keeps the operands in registers and shared memory and reads each
// from device memory once per block.
//
// Forward (kernel 2): a block computes a 64 x 64 tile of y, each of its 256
// threads a 4 x 4 register tile, walking K in steps of 32 with the x, w and
// beta slices of the step staged in shared memory. A thread counts the
// negative pre-activations of its outputs in integers; the sum over a K
// range of length L is L - 2 * count, so zero-filled edges (x = w = beta =
// 0 gives pre = +0, counted as +1 by Sign but not as a negative) need no
// correction term: only the count of real K rows enters. When the (M, N)
// tiles are too few to fill the card, K is split over gridDim.z and the
// partial sums meet in the zeroed output through atomicAdd. Every partial
// and total is an integer of magnitude <= K < 2^24, exact in float32, so the
// result is exact and deterministic in any order.
//
// Backward (kernels 3, 4, 5: one template, three instantiations): a block
// owns a 64 (K) x 64 (N) tile of w and beta, held in registers (4 x 4 per
// thread), and walks M in steps of 32 rows with the x and g slices staged
// in shared memory, so w and beta are read once and x and g once per block.
//   dw, dbeta: accumulated over the block's M range in registers. The M
//     range is split over gridDim.z when the (K, N) tiles alone are too few
//     to fill the card; the partials meet through atomicAdd into zeroed
//     outputs. With one split each element gets one add (deterministic);
//     with more, the float adds land in an order that varies from run to run.
//   dx: each thread sums its 4 n per row, the 16 lanes sharing a K column
//     reduce with warp shuffles, and one lane adds the block's sum over its
//     64 n into the zeroed dx with atomicAdd. Blocks of the N tiles meet in
//     no fixed order, so dx is not bit-deterministic: it agrees with the
//     plain version within float32 reassociation (the reference's own
//     1e-4 tolerance).
// Kernel 5 computes the mask once for all three gradients; kernels 3 and 4
// are the same loop with one side compiled out. Ragged M, K and N edges are
// masked here (zero-filled loads, guarded stores); nothing is padded.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 64;    // output columns (and rows) per block
constexpr int FWD_TK = 32;  // K rows staged per forward step
constexpr int BWD_TM = 32;  // M rows staged per backward step
constexpr int TARGET_BLOCKS = 264;  // about two blocks per SM on 132 SMs

__device__ __forceinline__ float pre_act(float x, float w, float b) {
  return __fadd_rn(__fmul_rn(x, w), b);
}

__global__ void __launch_bounds__(THREADS)
cac_train_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ beta, float* __restrict__ y,
                     int M, int N, int K, int k_per_split) {
  __shared__ float xs[FWD_TK][TILE];  // transposed: xs[k][m]
  __shared__ float ws[FWD_TK][TILE];
  __shared__ float bs[FWD_TK][TILE];
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // rows ty + 16 i, columns tx + 16 j
  const int m0 = blockIdx.y * TILE, n0 = blockIdx.x * TILE;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  int neg[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) neg[i][j] = 0;

  for (int kc = k_begin; kc < k_end; kc += FWD_TK) {
    __syncthreads();
    for (int e = tid; e < TILE * FWD_TK; e += THREADS) {
      const int r = e / FWD_TK, kk = e % FWD_TK;  // x: neighbouring threads on k
      const int m = m0 + r, k = kc + kk;
      xs[kk][r] = (m < M && k < k_end) ? x[(size_t)m * K + k] : 0.f;
    }
    for (int e = tid; e < TILE * FWD_TK; e += THREADS) {
      const int kk = e / TILE, c = e % TILE;  // w, beta: neighbouring threads on n
      const int k = kc + kk, n = n0 + c;
      const bool ok = k < k_end && n < N;
      ws[kk][c] = ok ? w[(size_t)k * N + n] : 0.f;
      bs[kk][c] = ok ? beta[(size_t)k * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < FWD_TK; ++kk) {
      float xv[4], wv[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wv[j] = ws[kk][tx + 16 * j];
        bv[j] = bs[kk][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          neg[i][j] += !(pre_act(xv[i], wv[j], bv[j]) >= 0.f);  // NaN counts as -1
    }
  }
  const int len = k_end - k_begin;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (m < M && n < N) atomicAdd(&y[(size_t)m * N + n], (float)(len - 2 * neg[i][j]));
    }
  }
}

template <bool DX, bool DW>
__global__ void __launch_bounds__(THREADS)
cac_train_bwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ beta, const float* __restrict__ g,
                     float* __restrict__ dx, float* __restrict__ dw,
                     float* __restrict__ db, int M, int N, int K, int m_per_split) {
  __shared__ float xs[BWD_TM][TILE];
  __shared__ float gs[BWD_TM][TILE];
  const int tid = threadIdx.x;
  // the 16 lanes of a half-warp share kg: the dx shuffle stays inside them
  const int kg = tid / 16, ng = tid % 16;  // k = k0 + kg + 16 i, n = n0 + ng + 16 j
  const int k0 = blockIdx.y * TILE, n0 = blockIdx.x * TILE;
  const int m_begin = blockIdx.z * m_per_split;
  const int m_end = min(M, m_begin + m_per_split);

  float wr[4][4], br[4][4], dwa[4][4], dba[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + kg + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + ng + 16 * j;
      const bool ok = k < K && n < N;
      wr[i][j] = ok ? w[(size_t)k * N + n] : 0.f;
      br[i][j] = ok ? beta[(size_t)k * N + n] : 0.f;
      dwa[i][j] = 0.f;
      dba[i][j] = 0.f;
    }
  }

  for (int mc = m_begin; mc < m_end; mc += BWD_TM) {
    __syncthreads();
    for (int e = tid; e < BWD_TM * TILE; e += THREADS) {
      const int r = e / TILE, c = e % TILE;
      const int m = mc + r;
      const bool mok = m < m_end;
      xs[r][c] = (mok && k0 + c < K) ? x[(size_t)m * K + k0 + c] : 0.f;
      gs[r][c] = (mok && n0 + c < N) ? g[(size_t)m * N + n0 + c] : 0.f;
    }
    __syncthreads();
    const int rows = min(BWD_TM, m_end - mc);
    for (int r = 0; r < rows; ++r) {
      float xv[4], gv[4], dxp[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        xv[i] = xs[r][kg + 16 * i];
        dxp[i] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) gv[j] = gs[r][ng + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float pre = pre_act(xv[i], wr[i][j], br[i][j]);
          const float gm = fabsf(pre) <= 1.f ? gv[j] : 0.f;
          if (DW) {
            dwa[i][j] += gm * xv[i];
            dba[i][j] += gm;
          }
          if (DX) dxp[i] += gm * wr[i][j];
        }
      if (DX) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int off = 8; off > 0; off >>= 1)
            dxp[i] += __shfl_xor_sync(0xffffffffu, dxp[i], off);
        if (ng == 0) {
          const int m = mc + r;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int k = k0 + kg + 16 * i;
            if (k < K) atomicAdd(&dx[(size_t)m * K + k], dxp[i]);
          }
        }
      }
    }
  }
  if (DW) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + kg + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + ng + 16 * j;
        if (k < K && n < N) {
          atomicAdd(&dw[(size_t)k * N + n], dwa[i][j]);
          atomicAdd(&db[(size_t)k * N + n], dba[i][j]);
        }
      }
    }
  }
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// Split `len` over enough parts that `tiles * parts` reaches TARGET_BLOCKS,
// each part a multiple of `step`. Returns the part length.
int split_len(int len, int tiles, int step) {
  int parts = std::max(1, cdiv(TARGET_BLOCKS, tiles));
  parts = std::min(parts, cdiv(len, step));
  return cdiv(cdiv(len, parts), step) * step;
}

}  // namespace

// Kernel 2. x (M, K), w and beta (K, N) -> y (M, N), all float32. Zeroes y,
// launches on `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int cac_train_fwd_launch(const void* x, const void* w, const void* beta, void* y,
                                    int M, int N, int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // float32 holds every count exactly only while |y| <= K < 2^24
  if (M <= 0 || N <= 0 || K <= 0 || K >= (1 << 24)) return (int)cudaErrorInvalidValue;
  const int gn = cdiv(N, TILE), gm = cdiv(M, TILE);
  const int k_per_split = split_len(K, gn * gm, FWD_TK);
  cudaError_t err = cudaMemsetAsync(y, 0, (size_t)M * N * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(gn, gm, cdiv(K, k_per_split));
  cac_train_fwd_kernel<<<grid, THREADS, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(beta), static_cast<float*>(y), M, N, K, k_per_split);
  return (int)cudaGetLastError();
}

// Kernels 3, 4 and 5. x (M, K), w and beta (K, N), g (M, N) float32. With
// dx non-null writes dx (M, K); with dw non-null writes dw and db (K, N):
// both -> the fused kernel 5, dx only -> kernel 3, dw only -> kernel 4.
// Zeroes its outputs, launches on `stream`, does not synchronise, returns
// cudaGetLastError().
extern "C" int cac_train_bwd_launch(const void* x, const void* w, const void* beta,
                                    const void* g, void* dx, void* dw, void* db,
                                    int M, int N, int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool want_dx = dx != nullptr, want_dw = dw != nullptr;
  if (M <= 0 || N <= 0 || K <= 0 || (!want_dx && !want_dw) || (want_dw != (db != nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (want_dx) err = cudaMemsetAsync(dx, 0, (size_t)M * K * sizeof(float), st);
  if (err == cudaSuccess && want_dw) err = cudaMemsetAsync(dw, 0, (size_t)K * N * sizeof(float), st);
  if (err == cudaSuccess && want_dw) err = cudaMemsetAsync(db, 0, (size_t)K * N * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  const int gn = cdiv(N, TILE), gk = cdiv(K, TILE);
  const int m_per_split = split_len(M, gn * gk, BWD_TM);
  const dim3 grid(gn, gk, cdiv(M, m_per_split));
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(beta);
  const float* gf = static_cast<const float*>(g);
  float* dxf = static_cast<float*>(dx);
  float* dwf = static_cast<float*>(dw);
  float* dbf = static_cast<float*>(db);
  if (want_dx && want_dw)
    cac_train_bwd_kernel<true, true><<<grid, THREADS, 0, st>>>(xf, wf, bf, gf, dxf, dwf, dbf,
                                                               M, N, K, m_per_split);
  else if (want_dx)
    cac_train_bwd_kernel<true, false><<<grid, THREADS, 0, st>>>(xf, wf, bf, gf, dxf, dwf, dbf,
                                                                M, N, K, m_per_split);
  else
    cac_train_bwd_kernel<false, true><<<grid, THREADS, 0, st>>>(xf, wf, bf, gf, dxf, dwf, dbf,
                                                                M, N, K, m_per_split);
  return (int)cudaGetLastError();
}
