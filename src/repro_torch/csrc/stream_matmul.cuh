// One streaming template for the small-M products over a (K, N) weight
// matrix that is read once: the served CAC (kernel 1, every M), the sign
// product at decode and prefill shapes (kernel 6, M <= the route threshold)
// and its packed serve form (kernel 7, every M). Included by cac_matmul.cu,
// bnn_matmul.cu and qnn_matmul.cu (kernel 10's sibling kernel takes only the
// cluster helpers, `config` and `cluster_max_blocks`); each instantiates the
// operations it needs.
//
//   CAC          y[m, n] = sum_k (x[m, k] >= tau[k, n] ? s[k, n] : -s[k, n])
//                x int8 (M, K), tau int8 (K, N), s uint8 planes (K/8, N) (bit
//                j of byte r is row 8r + j, 1 -> +1), K % 8 == 0
//   SIGN_I8      y[m, n] = sum_k sign(x[m, k]) sign(w[k, n]), x float32 (M, K),
//   SIGN_F32     w int8 or float32 (K, N); sign(v) = v >= 0 ? +1 : -1 (+-0 give
//                +1, NaN -1), never read from the float's sign bit
//   SIGN_PACKED  y[m, n] = sum_k sign(x[m, k]) (s[k, n] ? +1 : -1), x float32
//                (M, K), s uint8 planes (K/8, N) as for CAC, K % 8 == 0
//
// What bounds it on the H100: at M = 4 the weight bytes (K N for tau or w,
// K N / 8 for s) are about 2.5 MB at the path's largest projection, 0.75 us
// at 3.35 TB/s (0.09 us for kernel 7's planes alone); they are 21 KB an SM
// or less, fewer than one SM can keep in flight, so the kernel is bound by
// the latency of one pass over them, not by the memory rate. At M = 32 the
// compares are the larger cost (M K N / 4 byte lane words, two to five
// integer instructions each, on the CUDA cores).
//
// Design. Every op counts mismatches in byte lanes: one 32-bit word holds
// four columns, and y = L - 2 * mismatches over the L rows counted.
//   CAC: a term is +1 exactly when the compare bit [x >= tau] equals the s
//     bit. With xw = x's byte in all four lanes, t = (xw | 0x80808080) -
//     (tau & 0x7F7F7F7F) compares the low seven bits without a borrow
//     between lanes (bit 7 of each lane is [x & 0x7F >= tau & 0x7F]), and
//     f = (~xw & tau) | (~(xw ^ tau) & t) gives [x >= tau] as signed bytes
//     in bit 7 (x >= 0 > tau, or equal signs and the low-bit compare). The
//     s bit of row 8r + j is shifted to bit 7 of each lane, and
//     ((f ^ s) & 0x80808080) >> 7 adds one to a lane where they differ.
//   SIGN: the mismatch bit is w's negative bit XOR x's, both formed as
//     !(v >= 0) into bit 7 of a lane (int8: the sign bit is exactly v < 0).
//   SIGN_PACKED: x is staged as [x >= 0] in bit 7 of each lane (its positive
//     bit) and the plane bit of the row shifted to bit 7, as CAC's s; they
//     differ exactly where the term is -1, so a term is a shift, one LOP3
//     and the count.
// The logic steps run on the ALU pipe; the subtraction and the
// shift-and-add of the count are written as multiply-adds (mad.lo, mad.hi)
// so that they run on the multiply-add pipe beside it.
// Loads: the weight side in 16-byte vector loads (16 columns of one K row;
// float32 w as four 16-byte loads), the s planes 16 columns (8 K rows) a
// load, the x rows of the block staged once per chunk in shared memory as
// one word a (row, k) (CAC: the byte in all lanes; SIGN: 0 or 0x80808080).
// Ragged N (not a multiple of 16) and unaligned operands take byte loads.
//
// A block of 256 threads owns BN = 128 columns (8 column threads of 16) and
// MT rows: 4 at decode, else 8 (a larger M takes ceil(M / 8) row tiles, each
// reading the weights again, from L2; the serve path's M is at most 32);
// SIGN_PACKED takes 4 at every M, which ran faster than 8 at every serve
// shape on the H100 (its few weight bytes are cheap to read again). It
// walks its K range in chunks: 32 k-lanes, each taking a few items, all of
// whose loads go out before the first compare. An item is a half-group of
// 4 rows for CAC and SIGN (3 a chunk at MT = 4, else 2: chunks of 48 or 32
// groups; halving the groups puts every warp of a block to work at the
// decode shapes and halves a thread's serial compares) and a whole group of
// 8 rows for SIGN_PACKED, whose one 16-byte plane load holds them (2 a
// chunk: 64 groups, so that every decode split is one chunk). A thread
// counts at most 16 rows a chunk, so its byte lanes stay below 255; the
// warp's four k-lanes are summed by shuffles (at most 64 a lane), the eight
// warps through shared memory into 16-bit lanes and then into int32 sums
// that carry across chunks. Two blocks fit an SM.
// Where the (M, N) tiles are too few to fill the card, K is split over a
// thread block cluster (at most 8 blocks): every rank but 0 writes its
// counts into a slot of rank 0's shared memory and leaves, and rank 0 adds
// the slots in rank order after one cluster barrier. Every sum is an
// integer, so the result is exact and repeats bit for bit, and a call is
// one launch: no memset and no atomics. Rows of the last group past K
// (kernel 6 with K % 8 != 0) count as agreements on both sides.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace stream {

namespace cg = cooperative_groups;

enum Op { CAC = 0, SIGN_F32 = 1, SIGN_I8 = 2, SIGN_PACKED = 3 };

constexpr int THREADS = 256;
constexpr int CT = 8;               // column threads, 16 columns each
constexpr int BN = 16 * CT;         // columns per block
constexpr int KL = THREADS / CT;    // k-lanes per block (4 a warp)
constexpr int MAX_SPLITS = 8;       // the portable cluster size
constexpr uint32_t HI = 0x80808080u;

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// A tile of MT rows (4 at decode, else 8; SIGN_PACKED 4 at every M). A
// k-lane takes IPT items of RPI K rows per chunk: half-groups (4 rows of one
// 8-row group), 3 at MT = 4 and 2 at MT = 8, which keeps two blocks an SM
// within 128 registers (a chunk is 48 or 32 groups); for SIGN_PACKED whole
// groups, 2 (64 groups). The path's largest decode split, 40 groups, is one
// chunk.
template <int OP, int MT>
struct Tile {
  static_assert(MT == 4 || MT == 8, "row tile");
  static constexpr bool PACKED = OP == SIGN_PACKED;
  static_assert(!PACKED || MT == 4, "SIGN_PACKED takes 4-row tiles");
  static constexpr int RPI = PACKED ? 8 : 4;  // K rows an item
  static constexpr int IPT = PACKED ? 2 : (MT == 4 ? 3 : 2);
  static constexpr int CHUNK = RPI * KL * IPT;  // K rows per chunk
  static constexpr int Q = MT * 32;             // result words (4 columns each) a block
  static_assert(4 * RPI * IPT <= 255, "a warp's byte-lane counts stay below 256");
};

template <int OP, int MT>
struct Smem {
  uint32_t xs[MT][Tile<OP, MT>::CHUNK];       // the chunk's x words
  uint32_t red[THREADS / 32][MT][32];         // each warp's byte-lane counts
  int4 slot[MAX_SPLITS - 1][Tile<OP, MT>::Q];  // the leader's: ranks 1.. counts
};

// acc + (m >> 7) for m whose set bits are all bit 7 of a byte lane, as one
// multiply-add: (m (2^25 + 1)) >> 32 is m >> 7 when m's low 7 bits are 0 (a
// power-of-two factor would be turned back into a shift on the ALU pipe);
// the counts go to the multiply-add pipe, beside the compares' logic
__device__ __forceinline__ uint32_t add_shr7(uint32_t acc, uint32_t m) {
  uint32_t d;
  asm("mad.hi.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(m), "n"((1u << 25) + 1u), "r"(acc));
  return d;
}

// One LOP3 each, written out so that the compiler does not fold the later
// mask into the compare (which took three logic instructions for it):
// [x >= tau] in bit 7: (~xw & tw) | (~(xw ^ tw) & t), table 0x8E
__device__ __forceinline__ uint32_t compare_bits(uint32_t xw, uint32_t tw, uint32_t t) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x8E;" : "=r"(d) : "r"(xw), "r"(tw), "r"(t));
  return d;
}

// (a ^ b) & 0x80808080, table 0x28
__device__ __forceinline__ uint32_t differ_bits(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x28;" : "=r"(d) : "r"(a), "r"(b), "r"(HI));
  return d;
}

// a - b as a multiply-add (b * 0xFFFFFFFF + a, mod 2^32), on the same pipe
__device__ __forceinline__ uint32_t sub_mad(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(b), "n"(0xFFFFFFFFu), "r"(a));
  return d;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

// an arrival that publishes nothing (only that this block has started)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// negative bit of float32 v (NaN included) in bit 7 of byte lane `lane`
__device__ __forceinline__ uint32_t neg_lane(float v, int lane) {
  return v >= 0.f ? 0u : 0x80u << (8 * lane);
}

// Row k of the weight side at columns n .. n + 15, as four words of four
// byte lanes (CAC: tau as stored; SIGN_I8: w as stored, its bit 7 the
// negative bit; SIGN_F32: the negative bits). Zero when !ok; on the byte
// route a column at or past N is zero too.
template <int OP, bool VEC>
__device__ __forceinline__ uint4 weight_row(const void* __restrict__ w, int k, int n, int N,
                                            bool ok) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (!ok) return v;  // only the wanted rows issue loads
  if constexpr (OP == SIGN_F32) {
    const float* row = static_cast<const float*>(w) + (size_t)k * N + n;
    uint32_t q[4] = {0u, 0u, 0u, 0u};
    if (VEC) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(row) + c);
        q[c] = neg_lane(f.x, 0) | neg_lane(f.y, 1) | neg_lane(f.z, 2) | neg_lane(f.w, 3);
      }
    } else {
#pragma unroll
      for (int b = 0; b < 16; ++b)
        if (n + b < N) q[b / 4] |= neg_lane(row[b], b % 4);
    }
    v = make_uint4(q[0], q[1], q[2], q[3]);
  } else {
    const uint8_t* row = static_cast<const uint8_t*>(w) + (size_t)k * N + n;
    if (VEC) {
      v = __ldg(reinterpret_cast<const uint4*>(row));
    } else {
      uint32_t q[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int b = 0; b < 16; ++b)
        q[b / 4] |= (n + b < N ? (uint32_t)row[b] : 0u) << (8 * (b % 4));
      v = make_uint4(q[0], q[1], q[2], q[3]);
    }
  }
  return v;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The kernel. x (M, K): int8 for CAC, float32 otherwise; w (K, N): tau for
// CAC, unused for SIGN_PACKED; s (K/8, N) for CAC and SIGN_PACKED; y float32
// (M, N). Grid (N / BN, M / MT,
// splits), cluster (1, 1, splits); split z takes the 8-row groups [z per,
// (z + 1) per) of the ceil(K / 8).
template <int OP, bool VEC, int MT>
__global__ void __launch_bounds__(THREADS, 2)
stream_kernel(const void* __restrict__ x, const void* __restrict__ w,
              const uint8_t* __restrict__ s, float* __restrict__ y, int M, int N, int K,
              int groups_per_split) {
  using T = Tile<OP, MT>;
  constexpr int IPT = T::IPT, RPI = T::RPI, CHUNK = T::CHUNK, Q = T::Q;
  constexpr bool PLANES = OP == CAC || OP == SIGN_PACKED;  // reads s
  constexpr int QPT = (Q + THREADS - 1) / THREADS;  // result words per thread
  __shared__ __align__(16) Smem<OP, MT> sm;
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.block_rank(), nsplit = (int)cluster.num_blocks();
  if (nsplit > 1) cluster_arrive_relaxed();  // this block has started (waited on before DSMEM)
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ct = lane % CT, kl = 4 * warp + lane / CT;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * MT;
  const int n = n0 + 16 * ct;
  const int groups = (K + 7) / 8;
  const int g_begin = split * groups_per_split;
  const int g_end = min(groups, g_begin + groups_per_split);
  int acc[QPT][4];
#pragma unroll
  for (int i = 0; i < QPT; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[i][b] = 0;

  for (int cg0 = g_begin; cg0 < g_end; cg0 += CHUNK / 8) {
    const int kc = 8 * cg0;
    const int rows = min(CHUNK, 8 * g_end - kc);  // may pass K by up to 7 rows
    // this k-lane's items of the chunk, h = kl + KL i: rows RPI h .. RPI h
    // + RPI - 1 of the chunk (group cg0 + h / 2, its rows 4 (h % 2) .., for a
    // half-group; group cg0 + h for a whole one). Every load goes out first,
    // before the x rows are staged, and all are in flight together.
    uint4 wv[T::PACKED ? 1 : IPT][4];  // (SIGN_PACKED reads the planes only)
    uint4 sv[IPT];
    bool live[IPT];
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
      const int h = kl + KL * i, g = cg0 + h * RPI / 8, k0 = kc + RPI * h;
      live[i] = g < g_end && n < N;
      if constexpr (OP != SIGN_PACKED) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wv[i][j] = weight_row<OP, VEC>(w, k0 + j, n, N, live[i] && k0 + j < K);
      }
      if constexpr (PLANES) {
        sv[i] = make_uint4(0u, 0u, 0u, 0u);
        if (VEC && live[i]) {
          sv[i] = __ldg(reinterpret_cast<const uint4*>(s + (size_t)g * N + n));
        } else if (live[i]) {
          uint32_t q[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int b = 0; b < 16; ++b)
            q[b / 4] |= (n + b < N ? (uint32_t)s[(size_t)g * N + n + b] : 0u) << (8 * (b % 4));
          sv[i] = make_uint4(q[0], q[1], q[2], q[3]);
        }
      }
    }

    // the chunk's x rows: every load goes out before the first is used
    constexpr int XPT = MT * CHUNK / THREADS;
    uint32_t xv[XPT];
#pragma unroll
    for (int i = 0; i < XPT; ++i) {
      const int e = tid + THREADS * i, r = e / CHUNK, kk = e % CHUNK;
      const int m = m0 + r, k = kc + kk;
      xv[i] = 0u;
      if (kk < rows && m < M && k < K) {
        if constexpr (OP == CAC)
          xv[i] = (uint32_t)static_cast<const uint8_t*>(x)[(size_t)m * K + k] * 0x01010101u;
        else if constexpr (OP == SIGN_PACKED)  // the positive bit
          xv[i] = static_cast<const float*>(x)[(size_t)m * K + k] >= 0.f ? HI : 0u;
        else  // the negative bit
          xv[i] = static_cast<const float*>(x)[(size_t)m * K + k] >= 0.f ? 0u : HI;
      }
    }
    if (cg0 != g_begin) __syncthreads();  // the previous chunk's readers of xs and red are done
#pragma unroll
    for (int i = 0; i < XPT; ++i) {
      const int e = tid + THREADS * i;
      sm.xs[e / CHUNK][e % CHUNK] = xv[i];
    }
    __syncthreads();

    uint32_t cnt[MT][4];  // byte lanes: mismatches of 4 columns, at most RPI IPT each
#pragma unroll
    for (int r = 0; r < MT; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) cnt[r][c] = 0u;
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
      if (!live[i]) continue;
      const int h = kl + KL * i;
      if constexpr (OP == SIGN_PACKED) {  // rows RPI h .. of the chunk
        const int base = RPI == 8 ? 0 : 4 * (h % 2);  // the item's first row in its group
#pragma unroll
        for (int j = 0; j < RPI; ++j) {
          uint32_t xw[MT];
#pragma unroll
          for (int r = 0; r < MT; ++r) xw[r] = sm.xs[r][RPI * h + j];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            // the plane bit of row base + j of the group, moved to bit 7
            const uint32_t sb = word(sv[i], c) << (7 - base - j);
#pragma unroll
            for (int r = 0; r < MT; ++r) cnt[r][c] = add_shr7(cnt[r][c], differ_bits(sb, xw[r]));
          }
        }
      } else {
        const int half = 4 * (h % 2);  // rows 4 h .. of the chunk
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t xw[MT];
#pragma unroll
          for (int r = 0; r < MT; ++r) xw[r] = sm.xs[r][4 * h + j];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const uint32_t tw = word(wv[i][j], c);
            if constexpr (OP == CAC) {
              const uint32_t tlo = tw & 0x7F7F7F7Fu;
              // the s bit of row half + j of the group, moved to bit 7
              const uint32_t sb = word(sv[i], c) << (7 - half - j);
#pragma unroll
              for (int r = 0; r < MT; ++r) {
                const uint32_t t = sub_mad(xw[r] | HI, tlo);
                cnt[r][c] = add_shr7(cnt[r][c], differ_bits(compare_bits(xw[r], tw, t), sb));
              }
            } else {
#pragma unroll
              for (int r = 0; r < MT; ++r) cnt[r][c] = add_shr7(cnt[r][c], differ_bits(tw, xw[r]));
            }
          }
        }
      }
    }

    // the warp's four k-lanes (lanes ct, ct + 8, ct + 16, ct + 24): at most
    // 4 RPI IPT <= 64 a byte lane
#pragma unroll
    for (int r = 0; r < MT; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        uint32_t v = cnt[r][c];
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (lane < CT) sm.red[warp][r][4 * ct + c] = v;
      }
    __syncthreads();
    // the eight warps, in 16-bit lanes (at most 512), then into int32
#pragma unroll
    for (int i = 0; i < QPT; ++i) {
      const int q = tid + THREADS * i;
      if (q >= Q) break;
      uint32_t even = 0u, odd = 0u;
#pragma unroll
      for (int wp = 0; wp < THREADS / 32; ++wp) {
        const uint32_t v = sm.red[wp][q / 32][q % 32];
        even += v & 0x00FF00FFu;
        odd += (v >> 8) & 0x00FF00FFu;
      }
      acc[i][0] += (int)(even & 0xFFFFu);
      acc[i][1] += (int)(odd & 0xFFFFu);
      acc[i][2] += (int)(even >> 16);
      acc[i][3] += (int)(odd >> 16);
    }
  }

  // Word q of the tile: row q / 32, columns n0 + 4 (q % 32) .. + 3; this
  // thread holds q = tid + THREADS i. With splits, every rank other than 0
  // writes its counts into rank 0's slot (distributed shared memory) and
  // leaves; rank 0 adds the slots to its own in rank order and stores.
  if (nsplit > 1) {
    cluster_wait();  // every block of the cluster has started
    if (split > 0) {
      int4* dst = cluster.map_shared_rank(&sm.slot[split - 1][0], 0);
#pragma unroll
      for (int i = 0; i < QPT; ++i) {
        const int q = tid + THREADS * i;
        if (q < Q) dst[q] = make_int4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
      cluster_arrive();  // releases the writes to rank 0
      return;
    }
    cluster_arrive();
    cluster_wait();  // every other rank's counts are in this block's slots
  }
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    const int q = tid + THREADS * i;
    if (q >= Q) break;
    int4 v = make_int4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    for (int r = 1; r < nsplit; ++r) {
      const int4 u = sm.slot[r - 1][q];
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    const int m = m0 + q / 32, nn = n0 + 4 * (q % 32);
    if (m >= M || nn >= N) continue;
    const float4 out = make_float4((float)(K - 2 * v.x), (float)(K - 2 * v.y),
                                   (float)(K - 2 * v.z), (float)(K - 2 * v.w));
    float* o = y + (size_t)m * N + nn;
    if (VEC) {  // N % 16 == 0: the four columns are inside
      *reinterpret_cast<float4*>(o) = out;
    } else {
      o[0] = out.x;
      if (nn + 1 < N) o[1] = out.y;
      if (nn + 2 < N) o[2] = out.z;
      if (nn + 3 < N) o[3] = out.w;
    }
  }
}

inline void config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute (&attr)[1], dim3 grid,
                   int splits) {
  cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
}

// How many blocks of `kernel` (THREADS threads, static shared memory only)
// the card keeps resident in clusters of `splits` along z: its cluster
// occupancy times splits; -1 if it cannot say or splits is out of range.
template <typename Kernel>
int cluster_max_blocks(Kernel kernel, int splits) {
  if (splits < 1 || splits > MAX_SPLITS) return -1;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  config(cfg, attr, dim3(1, 1, splits), splits);
  int clusters = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  return err == cudaSuccess ? clusters * splits : -1;
}

// The same for op OP with `mt`-row tiles (4, or 8 but for SIGN_PACKED;
// else -1).
template <int OP>
int max_blocks(int mt, int splits) {
  if (mt == 4) return cluster_max_blocks(stream_kernel<OP, true, 4>, splits);
  if constexpr (OP != SIGN_PACKED)
    if (mt == 8) return cluster_max_blocks(stream_kernel<OP, true, 8>, splits);
  return -1;
}

// Launch on `st` with the caller's plan: `mt` rows a tile (4 or 8; 4 for
// SIGN_PACKED), `splits` blocks a cluster, each taking `groups_per_split`
// 8-row groups. Returns cudaErrorInvalidValue for a plan or shape it does
// not take, else the launch's error.
template <int OP>
cudaError_t launch(const void* x, const void* w, const uint8_t* s, float* y, int M, int N, int K,
                   int mt, int splits, int groups_per_split, cudaStream_t st) {
  const int groups = cdiv(K, 8);
  if (M <= 0 || N <= 0 || K <= 0 || K >= (1 << 24) || (mt != 4 && mt != 8) ||
      (OP == SIGN_PACKED && mt != 4) || splits < 1 ||
      splits > MAX_SPLITS || groups_per_split < 1 ||
      (long long)splits * groups_per_split < groups ||
      (long long)(splits - 1) * groups_per_split >= groups)
    return cudaErrorInvalidValue;
  const bool vec = N % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(s) |
                     reinterpret_cast<uintptr_t>(y)) % 16) == 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  config(cfg, attr, dim3(cdiv(N, BN), cdiv(M, mt), splits), splits);
  cfg.stream = st;
#define STREAM_LAUNCH(VEC, MT)                                                          \
  return cudaLaunchKernelEx(&cfg, stream_kernel<OP, VEC, MT>, x, w, s, y, M, N, K, \
                            groups_per_split)
  if (mt == 4) {
    if (vec) STREAM_LAUNCH(true, 4);
    STREAM_LAUNCH(false, 4);
  }
  if constexpr (OP != SIGN_PACKED) {
    if (vec) STREAM_LAUNCH(true, 8);
    STREAM_LAUNCH(false, 8);
  }
#undef STREAM_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace stream
