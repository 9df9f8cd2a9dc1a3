// Int8 matmul with per-column dequantization, for Hopper (sm_90a).
//
// Replaces the Pallas kernel qnn_matmul_kernel_call (kernel 10,
// src/repro/kernels/qnn_matmul.py:73), the serving product of the QNN
// baseline:
//   y[m, n] = float32(sum_k x[m, k] * w[k, n]) * (w_scale[n] * x_scale)
// x int8 (M, K) activation codes in -128..127, w int8 (K, N) in -127..127,
// both row-major and contiguous; w_scale float32 (N,); x_scale a float32;
// y float32 (M, N). The sum is an int32, exact (|acc| <= K * 128 * 127,
// checked below), and the epilogue rounds twice, as the reference's plain
// route does (src/repro/kernels/ref.py:60-67, core/backend.py:545-551):
//   __fmul_rn(__int2float_rn(acc), __fmul_rn(w_scale[n], x_scale)).
// So the kernel is bit-exact against its plain version at every size. The
// Pallas kernel itself adds float32 partials per 512-wide K block, which is
// the same only while |acc| < 2^24.
//
// Design. A block owns a BM x 64 tile of y (BM = 16, 32 or 64, the
// smallest that covers M up to 64) and walks its K range in stages of 64
// rows, with both operands staged in shared memory as 4-byte k-words:
//   - x: the word of row m at k is x[m, k..k+3], four consecutive bytes;
//   - w: a thread loads the 4-byte row words w[k+r, n..n+3] of four rows
//     r = 0..3 (neighbouring threads on neighbouring words, so a warp reads
//     whole row segments) and transposes the 4 x 4 bytes with __byte_perm
//     into the k-words of columns n..n+3 (the four bytes of a column word
//     lie N apart in memory, as with kernel 7's packed planes).
// Each thread then accumulates an RM x 4 register tile with __dp4a (four
// signed int8 products added into an int32 per instruction).
//
// Ragged edges are masked, nothing is padded: bytes at k >= K (or past the
// block's K range) and columns n >= N load as 0 on both sides, so they add
// nothing; rows m >= M load as 0 and are not stored. Where K (for x) or N
// (for w) is a multiple of 4 and the pointer is 4-byte aligned, a word is
// one 32-bit load; otherwise the four bytes are loaded one by one, each
// under its own bound.
//
// Grid size. At decode (M = 4) the (M, N) tiles are few (15 at N = 960),
// so K is split over gridDim.z until the blocks reach ~2 per SM. The K
// splits meet through int32 atomicAdd into a zeroed workspace (exact and
// independent of order; never float atomics, which would round once |acc|
// passes 2^24). The last block of a tile to finish (a per-tile counter,
// the fence-then-count pattern) reads the tile's sums back from L2 and
// writes the dequantized y. With one split a block writes y directly.
//
// What bounds it on the H100: bytes. At decode the weight read is the
// work (2.46 MB at K = 960, N = 2560: 0.73 us at 3.35 TB/s), and the
// 2 M K N operations are far under the int8 tensor-core peak; the CUDA-core
// __dp4a here does 4 products an instruction, which suffices at decode but
// not at large M (int8 mma is for a later PR). x is re-read once per
// column tile, from L2.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;
constexpr int BN = 64;          // output columns per block
constexpr int BK = 64;          // K rows per stage
constexpr int KW = BK / 4;      // 4-byte k-words per stage
constexpr int NUM_SMS = 132;
constexpr int TARGET_BLOCKS = 2 * NUM_SMS;
static_assert(KW * (BN / 4) == THREADS, "one w unit (k-word, 4 columns) per thread");

int cdiv(int a, int b) { return (a + b - 1) / b; }

// The int8 at p[0..valid-1] as the low bytes of a little-endian word, the
// rest 0. With `aligned`, valid is 0 or 4 and p is 4-byte aligned: one load.
__device__ __forceinline__ uint32_t load4(const int8_t* __restrict__ p, int valid, bool aligned) {
  if (valid <= 0) return 0u;
  if (aligned) return __ldg(reinterpret_cast<const unsigned int*>(p));
  uint32_t word = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (b < valid) word |= (uint32_t)(uint8_t)__ldg(p + b) << (8 * b);
  return word;
}

template <int BM>
__global__ void __launch_bounds__(THREADS)
qnn_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
           const float* __restrict__ w_scale, float x_scale, float* __restrict__ y,
           int* __restrict__ acc_buf, int* __restrict__ tile_count, int M, int N, int K,
           int k_per_split, bool x_aligned, bool w_aligned) {
  constexpr int RM = BM / 16;  // output rows per thread: ty + 16 i
  __shared__ uint32_t xs[BM][KW];
  __shared__ __align__(16) uint32_t ws[KW][BN];
  __shared__ bool last_block;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // columns tx + 16 j
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  int acc[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  const int wq = tid / (BN / 4), wc = tid % (BN / 4);  // this thread's w unit
  const int wn = n0 + 4 * wc;
  for (int kc = k_begin; kc < k_end; kc += BK) {
    __syncthreads();
    for (int e = tid; e < BM * KW; e += THREADS) {
      const int r = e / KW, s = e % KW;
      const int m = m0 + r, k = kc + 4 * s;
      xs[r][s] = load4(x + (size_t)m * K + k, m < M ? min(4, k_end - k) : 0, x_aligned);
    }
    uint32_t rw[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = kc + 4 * wq + r;
      rw[r] = load4(w + (size_t)k * N + wn, k < k_end ? min(4, N - wn) : 0, w_aligned);
    }
    // 4 x 4 byte transpose: row words (byte j = column wn + j) -> column
    // words (byte r = row 4 wq + r)
    const uint32_t t0 = __byte_perm(rw[0], rw[1], 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
    const uint32_t t1 = __byte_perm(rw[2], rw[3], 0x5140);  // r2.b0 r3.b0 r2.b1 r3.b1
    const uint32_t t2 = __byte_perm(rw[0], rw[1], 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
    const uint32_t t3 = __byte_perm(rw[2], rw[3], 0x7362);
    *reinterpret_cast<uint4*>(&ws[wq][4 * wc]) =
        make_uint4(__byte_perm(t0, t1, 0x5410), __byte_perm(t0, t1, 0x7632),
                   __byte_perm(t2, t3, 0x5410), __byte_perm(t2, t3, 0x7632));
    __syncthreads();
#pragma unroll
    for (int q = 0; q < KW; ++q) {
      int xv[RM], wv[4];
#pragma unroll
      for (int i = 0; i < RM; ++i) xv[i] = (int)xs[ty + 16 * i][q];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = (int)ws[q][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(xv[i], wv[j], acc[i][j]);
    }
  }

  float scale[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx + 16 * j;
    scale[j] = n < N ? __fmul_rn(__ldg(w_scale + n), x_scale) : 0.f;
  }
  if (gridDim.z == 1) {
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int m = m0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx + 16 * j;
        if (m < M && n < N) y[(size_t)m * N + n] = __fmul_rn(__int2float_rn(acc[i][j]), scale[j]);
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int m = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (m < M && n < N) atomicAdd(&acc_buf[(size_t)m * N + n], acc[i][j]);
    }
  }
  __threadfence();  // this thread's sums reach L2 before the block is counted
  __syncthreads();
  if (tid == 0)
    last_block = atomicAdd(&tile_count[blockIdx.y * gridDim.x + blockIdx.x], 1) ==
                 (int)gridDim.z - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int m = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (m < M && n < N) {
        const int total = __ldcg(&acc_buf[(size_t)m * N + n]);  // from L2, not L1
        y[(size_t)m * N + n] = __fmul_rn(__int2float_rn(total), scale[j]);
      }
    }
  }
}

template <int BM>
void launch(const int8_t* x, const int8_t* w, const float* ws, float xs, float* y, int* acc,
            int* count, int M, int N, int K, int kps, bool xa, bool wa, dim3 grid,
            cudaStream_t st) {
  qnn_kernel<BM><<<grid, THREADS, 0, st>>>(x, w, ws, xs, y, acc, count, M, N, K, kps, xa, wa);
}

}  // namespace

// Kernel 10. x int8 (M, K), w int8 (K, N), w_scale float32 (N,), x_scale
// -> y float32 (M, N). `workspace` is int32 scratch of `workspace_elems`
// >= M * N + cdiv(M, 16) * cdiv(N, 64) elements (the split-K sums and the
// per-tile counters; zeroed here when K is split). Launches on `stream`,
// does not synchronise, returns cudaGetLastError() (or the memset's error).
extern "C" int qnn_matmul_launch(const void* x, const void* w, const void* w_scale,
                                 float x_scale, void* y, void* workspace,
                                 long long workspace_elems, int M, int N, int K,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the int32 accumulator is exact only while K * 128 * 127 < 2^31
  if (M <= 0 || N <= 0 || K <= 0 || (long long)K * 128 * 127 > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const int bm = M <= 16 ? 16 : (M <= 32 ? 32 : 64);
  const int gn = cdiv(N, BN), gm = cdiv(M, bm);
  // split K (in whole stages) until the blocks reach TARGET_BLOCKS
  int parts = std::min(std::max(1, cdiv(TARGET_BLOCKS, gn * gm)), cdiv(K, BK));
  const int k_per_split = cdiv(cdiv(K, parts), BK) * BK;
  parts = cdiv(K, k_per_split);
  const long long mn = (long long)M * N;
  if (workspace_elems < mn + (long long)gn * gm) return (int)cudaErrorInvalidValue;
  int* acc = static_cast<int*>(workspace);
  int* count = acc + mn;
  if (parts > 1) {
    cudaError_t err = cudaMemsetAsync(acc, 0, (size_t)(mn + (long long)gn * gm) * sizeof(int), st);
    if (err != cudaSuccess) return (int)err;
  }
  const bool xa = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0;
  const bool wa = N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0;
  const dim3 grid(gn, gm, parts);
  const int8_t* xi = static_cast<const int8_t*>(x);
  const int8_t* wi = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(w_scale);
  float* yf = static_cast<float*>(y);
  if (bm == 16)
    launch<16>(xi, wi, sc, x_scale, yf, acc, count, M, N, K, k_per_split, xa, wa, grid, st);
  else if (bm == 32)
    launch<32>(xi, wi, sc, x_scale, yf, acc, count, M, N, K, k_per_split, xa, wa, grid, st);
  else
    launch<64>(xi, wi, sc, x_scale, yf, acc, count, M, N, K, k_per_split, xa, wa, grid, st);
  return (int)cudaGetLastError();
}
