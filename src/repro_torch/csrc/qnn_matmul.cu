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
// Two routes, chosen by the caller from M (repro_torch.kernels.qnn_matmul
// .qnn_plan):
//
// Stream route (the serve path's M: decode 4, the draft's bucketed prefill
// 16, prefill chunks 32). What bounds it on the H100: at decode the weight
// read is the work (2.46 MB at K = 960, N = 2560: 0.73 us at 3.35 TB/s),
// 20 KB an SM, fewer bytes than one SM keeps in flight, so one pass's
// latency sets the time; at M = 32 the M K N / 4 __dp4a are about 1.3 us
// across the card's CUDA cores. The design is stream_matmul.cuh's (kernels
// 1, 6 and 7), with int32 sums: a block of 256 threads owns 128 columns (16
// column threads of 8) and MT rows (4 at decode, else 8, by
// kernels/cac_matmul.stream_plan); 16 k-lanes take quads of 4 K rows, IPT a
// chunk (5 at MT = 4, 2 at MT = 8, within 128 registers and no spill; 2 and
// 1 on the byte route of ragged shapes), and every load of a chunk goes out
// before the first product: w as four 8-byte loads along N
// (4 rows x 8 columns), x as one 4-byte word per row of the tile (read
// directly, no shared-memory stage, so the loop has no barrier). Exact
// products need the 4 K rows of one column in a word for __dp4a, but w is
// (K, N) row-major: the 4 x 4 byte blocks are transposed in registers with
// __byte_perm (8 an item and column word), and __dp4a adds four signed
// products into an int32 a (row, column). The sums carry across chunks; at
// the end the two k-lanes of a warp meet by a shuffle and the eight warps
// through shared memory (warps 4..7 hand theirs to 0..3). Where the (M, N)
// tiles are too few to fill the card, K is split over a thread block
// cluster (at most 8 blocks, whole 8-row groups each): every rank but 0
// writes its sums into a slot of rank 0's shared memory and leaves, and
// rank 0 adds them in rank order, dequantizes and stores. One launch, no
// memset, no atomics, no workspace; exact and repeatable bit for bit.
//
// Tile route (M above the route threshold; on no serve path). A block owns
// a BM x 64 tile of y (BM = 16, 32 or 64, the smallest that covers M up to
// 64) and walks its K range in stages of 64 rows, with both operands staged
// in shared memory as 4-byte k-words:
//   - x: the word of row m at k is x[m, k..k+3], four consecutive bytes;
//   - w: a thread loads the 4-byte row words w[k+r, n..n+3] of four rows
//     r = 0..3 (neighbouring threads on neighbouring words, so a warp reads
//     whole row segments) and transposes the 4 x 4 bytes with __byte_perm
//     into the k-words of columns n..n+3.
// Each thread then accumulates an RM x 4 register tile with __dp4a. Where
// the tiles are few, K is split over gridDim.z until the blocks reach ~2 per
// SM; the splits meet through int32 atomicAdd into a zeroed workspace
// (exact and independent of order) and the last block of a tile to finish
// (a per-tile counter) writes the dequantized y. Bound at M = 512 by the
// __dp4a on the CUDA cores (int8 tensor cores are for a later design).
//
// Both routes mask ragged edges, nothing is padded: bytes at k >= K and
// columns n >= N load as 0 on both sides, so they add nothing; rows m >= M
// load as 0 and are not stored. Where K (for x) and N (for w) allow aligned
// words, a word is one load; otherwise the bytes are loaded one by one, each
// under its own bound.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "stream_matmul.cuh"

namespace {

namespace cg = cooperative_groups;

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

// ---- stream route ----

constexpr int S_CT = 16;                      // column threads, 8 columns each
constexpr int S_KL = stream::THREADS / S_CT;  // k-lanes: 2 a warp
static_assert(8 * S_CT == stream::BN, "the stream plan's 128-column tiles");

// MT rows a tile (4 or 8, as stream_plan picks them); a k-lane takes IPT
// quads (4 K rows) a chunk: 5 or 2 on the vector route, 2 or 1 on the byte
// route (ragged shapes), whose eight loads a row word hold more registers
template <bool VEC, int MT>
struct QTile {
  static_assert(MT == 4 || MT == 8, "row tile");
  static constexpr int IPT = VEC ? (MT == 4 ? 5 : 2) : (MT == 4 ? 2 : 1);
  static constexpr int CHUNK_Q = S_KL * IPT;     // quads a chunk
  static constexpr int Q = MT * stream::BN / 4;  // result words (4 columns each) a block
  static_assert(Q <= stream::THREADS, "one result word a thread");
};

template <int MT>
struct QSmem {
  int4 red[4][MT][stream::BN / 4];                  // warps 4..7's sums, then 0..3's
  int4 slot[stream::MAX_SPLITS - 1][MT * stream::BN / 4];  // the leader's: ranks 1.. sums
};

// Row k of w at columns n .. n + 7 as two words of four byte lanes (column
// n + b in byte b % 4 of word b / 4); zero when !ok, and on the byte route
// a column at or past N is zero too.
template <bool VEC>
__device__ __forceinline__ uint2 w_row(const int8_t* __restrict__ w, int k, int n, int N,
                                       bool ok) {
  if (!ok) return make_uint2(0u, 0u);  // only the wanted rows issue loads
  const int8_t* row = w + (size_t)k * N + n;
  if (VEC) return __ldg(reinterpret_cast<const uint2*>(row));
  uint32_t q[2] = {0u, 0u};
#pragma unroll
  for (int b = 0; b < 8; ++b)
    if (n + b < N) q[b / 4] |= (uint32_t)(uint8_t)__ldg(row + b) << (8 * (b % 4));
  return make_uint2(q[0], q[1]);
}

// x[m, k0 .. k0 + 3] as one word (byte j = row k0 + j); zero when !ok, and
// on the byte route a row at or past K is zero too.
template <bool VEC>
__device__ __forceinline__ uint32_t x_word(const int8_t* __restrict__ x, int m, int k0, int K,
                                           bool ok) {
  if (!ok) return 0u;
  const int8_t* p = x + (size_t)m * K + k0;
  if (VEC) return __ldg(reinterpret_cast<const unsigned int*>(p));
  uint32_t v = 0u;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (k0 + b < K) v |= (uint32_t)(uint8_t)__ldg(p + b) << (8 * b);
  return v;
}

// 4 x 4 byte transpose: row words r[j] (byte b = column b) -> column words
// c[b] (byte j = row j)
__device__ __forceinline__ void transpose4(uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3,
                                           uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
  const uint32_t t1 = __byte_perm(r2, r3, 0x5140);  // r2.b0 r3.b0 r2.b1 r3.b1
  const uint32_t t2 = __byte_perm(r0, r1, 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
  const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
  c[0] = __byte_perm(t0, t1, 0x5410);
  c[1] = __byte_perm(t0, t1, 0x7632);
  c[2] = __byte_perm(t2, t3, 0x5410);
  c[3] = __byte_perm(t2, t3, 0x7632);
}

// Grid (N / 128, M / MT, splits), cluster (1, 1, splits); split z takes the
// 8-row groups [z per, (z + 1) per) of the ceil(K / 8), i.e. the quads [2 z
// per, 2 (z + 1) per) of the ceil(K / 4).
template <bool VEC, int MT>
__global__ void __launch_bounds__(stream::THREADS, 2)
qnn_stream_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ w_scale, float x_scale, float* __restrict__ y,
                  int M, int N, int K, int groups_per_split) {
  using T = QTile<VEC, MT>;
  constexpr int IPT = T::IPT, CHUNK_Q = T::CHUNK_Q, Q = T::Q;
  __shared__ __align__(16) QSmem<MT> sm;
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.block_rank(), nsplit = (int)cluster.num_blocks();
  if (nsplit > 1) stream::cluster_arrive_relaxed();  // started (waited on before DSMEM)
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ct = lane % S_CT, kl = 2 * warp + lane / S_CT;
  const int n0 = blockIdx.x * stream::BN, m0 = blockIdx.y * MT;
  const int n = n0 + 8 * ct;
  const int quads = (K + 3) / 4;
  const int q_begin = 2 * split * groups_per_split;
  const int q_end = min(quads, q_begin + 2 * groups_per_split);
  int acc[MT][8];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0;

  for (int qc = q_begin; qc < q_end; qc += CHUNK_Q) {
    // this k-lane's quads h = qc + kl + S_KL i: every load of the chunk goes
    // out before the first product
    uint2 wv[IPT][4];
    uint32_t xv[IPT][MT];
    bool live[IPT];
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
      const int h = qc + kl + S_KL * i, k0 = 4 * h;
      live[i] = h < q_end && n < N;
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[i][j] = w_row<VEC>(w, k0 + j, n, N, live[i] && k0 + j < K);
#pragma unroll
      for (int r = 0; r < MT; ++r)
        xv[i][r] = x_word<VEC>(x, m0 + r, k0, K, live[i] && m0 + r < M);
    }
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
      if (!live[i]) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // columns 4 half .. 4 half + 3
        uint32_t col[4];
        if (half == 0)
          transpose4(wv[i][0].x, wv[i][1].x, wv[i][2].x, wv[i][3].x, col);
        else
          transpose4(wv[i][0].y, wv[i][1].y, wv[i][2].y, wv[i][3].y, col);
#pragma unroll
        for (int b = 0; b < 4; ++b)
#pragma unroll
          for (int r = 0; r < MT; ++r)
            acc[r][4 * half + b] = __dp4a((int)xv[i][r], (int)col[b], acc[r][4 * half + b]);
      }
    }
  }

  // the warp's two k-lanes (lanes ct and ct + 16), then the eight warps:
  // 4..7 hand their sums to 0..3, which leave the four in red
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], 16);
  const bool holder = lane < S_CT;
  if (warp >= 4 && holder) {
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      sm.red[warp - 4][r][2 * ct] = make_int4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      sm.red[warp - 4][r][2 * ct + 1] = make_int4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
    }
  }
  __syncthreads();
  if (warp < 4 && holder) {
#pragma unroll
    for (int r = 0; r < MT; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int4& v = sm.red[warp][r][2 * ct + h];
        const int4 u = v;
        v = make_int4(u.x + acc[r][4 * h], u.y + acc[r][4 * h + 1], u.z + acc[r][4 * h + 2],
                      u.w + acc[r][4 * h + 3]);
      }
  }
  __syncthreads();
  // word q = tid of the tile: row q / 32, columns n0 + 4 (q % 32) .. + 3
  const int q = tid;
  const bool has = q < Q;
  int4 v = make_int4(0, 0, 0, 0);
  if (has) {
#pragma unroll
    for (int wp = 0; wp < 4; ++wp) {
      const int4 u = sm.red[wp][q / 32][q % 32];
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
  }
  // With splits, every rank other than 0 writes its sums into rank 0's slot
  // (distributed shared memory) and leaves; rank 0 adds them in rank order.
  if (nsplit > 1) {
    stream::cluster_wait();  // every block of the cluster has started
    if (split > 0) {
      if (has) cluster.map_shared_rank(&sm.slot[split - 1][0], 0)[q] = v;
      stream::cluster_arrive();  // releases the writes to rank 0
      return;
    }
    stream::cluster_arrive();
    stream::cluster_wait();  // every other rank's sums are in this block's slots
  }
  if (!has) return;
  for (int r = 1; r < nsplit; ++r) {
    const int4 u = sm.slot[r - 1][q];
    v.x += u.x;
    v.y += u.y;
    v.z += u.z;
    v.w += u.w;
  }
  const int m = m0 + q / 32, nn = n0 + 4 * (q % 32);
  if (m >= M || nn >= N) return;
  const int sums[4] = {v.x, v.y, v.z, v.w};
  float out[4];
#pragma unroll
  for (int b = 0; b < 4; ++b)
    out[b] = nn + b < N ? __fmul_rn(__int2float_rn(sums[b]), __fmul_rn(__ldg(w_scale + nn + b),
                                                                       x_scale))
                        : 0.f;
  float* o = y + (size_t)m * N + nn;
  if (VEC) {  // N % 8 == 0: the four columns are inside
    *reinterpret_cast<float4*>(o) = make_float4(out[0], out[1], out[2], out[3]);
  } else {
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (nn + b < N) o[b] = out[b];
  }
}

// the int32 sum is exact only while K * 128 * 127 < 2^31
bool k_ok(int K) { return K > 0 && (long long)K * 128 * 127 <= 2147483647LL; }


}  // namespace

// Kernel 10, tile route. x int8 (M, K), w int8 (K, N), w_scale float32
// (N,), x_scale -> y float32 (M, N). `workspace` is int32 scratch of `workspace_elems`
// >= M * N + cdiv(M, 16) * cdiv(N, 64) elements (the split-K sums and the
// per-tile counters; zeroed here when K is split). Launches on `stream`,
// does not synchronise, returns cudaGetLastError() (or the memset's error).
extern "C" int qnn_matmul_launch(const void* x, const void* w, const void* w_scale,
                                 float x_scale, void* y, void* workspace,
                                 long long workspace_elems, int M, int N, int K,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || !k_ok(K)) return (int)cudaErrorInvalidValue;
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

// Kernel 10, stream route. The operands as for the tile route, by the
// caller's plan (repro_torch.kernels.cac_matmul.stream_plan): `mt` rows a
// tile (4 or 8), `splits` blocks a cluster, each taking `groups_per_split`
// of the ceil(K / 8) 8-row groups. One launch, no workspace; writes every
// element of y, launches on `stream`, does not synchronise, returns the
// launch's error or cudaErrorInvalidValue for a plan or shape it does not
// take.
extern "C" int qnn_stream_launch(const void* x, const void* w, const void* w_scale,
                                 float x_scale, void* y, int M, int N, int K, int mt, int splits,
                                 int groups_per_split, void* stream) {
  const int groups = cdiv(K, 8);
  if (M <= 0 || N <= 0 || !k_ok(K) || (mt != 4 && mt != 8) || splits < 1 ||
      splits > stream::MAX_SPLITS || groups_per_split < 1 ||
      (long long)splits * groups_per_split < groups ||
      (long long)(splits - 1) * groups_per_split >= groups)
    return (int)cudaErrorInvalidValue;
  const bool vec = N % 8 == 0 && K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  stream::config(cfg, attr, dim3(cdiv(N, stream::BN), cdiv(M, mt), splits), splits);
  cfg.stream = static_cast<cudaStream_t>(stream);
  const int8_t* xi = static_cast<const int8_t*>(x);
  const int8_t* wi = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(w_scale);
  float* yf = static_cast<float*>(y);
  cudaError_t err;
#define QNN_STREAM(VEC, MT) \
  err = cudaLaunchKernelEx(&cfg, qnn_stream_kernel<VEC, MT>, xi, wi, sc, x_scale, yf, M, N, K, \
                           groups_per_split)
  if (vec) {
    if (mt == 4)
      QNN_STREAM(true, 4);
    else
      QNN_STREAM(true, 8);
  } else if (mt == 4) {
    QNN_STREAM(false, 4);
  } else {
    QNN_STREAM(false, 8);
  }
#undef QNN_STREAM
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// Resident blocks of the stream route with `mt`-row tiles in clusters of
// `splits` (the plan weighs waves with it); -1 if the card cannot say.
extern "C" int stream_max_blocks(int mt, int splits) {
  if (mt == 4) return stream::cluster_max_blocks(qnn_stream_kernel<true, 4>, splits);
  if (mt == 8) return stream::cluster_max_blocks(qnn_stream_kernel<true, 8>, splits);
  return -1;
}
