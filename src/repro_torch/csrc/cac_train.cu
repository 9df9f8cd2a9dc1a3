// Training-form BiKA comparator-accumulate (CAC) and its STE backward, for
// Hopper (sm_90a).
//
// Replaces four Pallas kernels of src/repro/kernels/cac_matmul.py:
//   cac_train_fwd_call        (kernel 2)  y  = sum_k Sign(x w + beta)
//   cac_train_bwd_dx_call     (kernel 3)  dx = sum_n g mask w
//   cac_train_bwd_dw_call     (kernel 4)  dw = sum_m g mask x, dbeta = sum_m g mask
//   cac_train_bwd_fused_call  (kernel 5)  all three from one mask recompute
// with  pre = x[m,k] * w[k,n] + beta[k,n],  Sign(0) = +1 (NaN -> -1),
//       mask = 1[|pre| <= 1]  (the hard-tanh STE window, inclusive).
// All operands float32: x (M, K), w and beta (K, N), g (M, N). No
// --use_fast_math: subnormals are kept (no flush to zero) and every product
// and sum below is an IEEE round-to-nearest one (__fmul_rn, __fadd_rn), so
// nvcc never contracts x * w + beta into one fused multiply-add.
//
// What bounds them on the H100: there is no tensor-core form of a
// compare-select, so the work is on the CUDA cores, where a scheduler
// issues one warp instruction a clock (132 SMs x 4 x 32 lanes at the boost
// clock, 33.5e12 thread instructions a second) and compares and integer or
// logic operations run on 16 lanes a partition, half that rate.
//
// Kernel 2, the forward: three instructions a term.
//   fl(fl(x w) + beta) >= 0  <=>  fl(x w) >= -beta  for finite beta, since a
//   rounded sum keeps the sign of the exact sum, a nonzero sum of two floats
//   is never smaller in magnitude than the smallest subnormal (so it never
//   rounds to zero), and a + (-a) rounds to +0 (while -0 >= 0 holds on both
//   sides). Two remaps keep an infinite beta exact: beta = +inf compares
//   against -FLT_MAX (only fl(x w) = -inf, whose sum is NaN, or a NaN
//   product fails) and beta = -inf against NaN (every sum is -inf or NaN:
//   always -1). A NaN beta stays NaN (-1), as does a NaN product. The
//   remapped threshold nb(beta) is formed once per staged element, in
//   shared memory, so a term is __fmul_rn, set.ge.f32.f32 (1.0 or 0.0) and
//   an FP32 add into the count of +1 terms: one instruction of three on the
//   half-rate pipe. Counts are integers below 2^24, exact in float32, and
//   y = 2 count - K.
//   A block of 256 threads owns a 128 (M) x 64 (N) tile, each thread 8 rows
//   x 4 columns, and walks its K range in slices of 16 rows, staged with
//   cp.async into a ring of three buffers (the next two slices load while
//   one is counted). x is staged as it lies (rows of 16 k, padded to 20
//   floats: eight consecutive rows hit eight disjoint bank quads), so no
//   transpose is needed: a thread reads x as float4 along k for its eight
//   rows and w and nb as float4 along n, 1.5 shared bytes a term. Rows past
//   M and columns past N are zero-filled and never stored; rows past the
//   split's K range get nb = NaN and count nothing.
//   Where the (M, N) tiles are too few to fill the card, K is split over a
//   thread block cluster of up to 8 ranks (the plan is the wrapper's, from
//   the card's SM count and cluster occupancy). Each rank leaves its counts
//   in its own shared memory; after a cluster barrier rank r adds, for its
//   share of the tile, the counts of ranks 0, 1, ... in rank order through
//   distributed shared memory and writes y. Every element of y is written
//   once: no memset and no atomics; the sums are integers, so y is exact.
//
// Kernel 5, the fused backward: five instructions a term.
//   The window |fl(fl(x w) + beta)| <= 1 is decided on x alone: it holds
//   exactly for x in [xlo, xhi], two floats per (k, n) found once per tile.
//   Round to nearest even keeps fl(v) in [-1, 1] exactly for v in
//   [-1 - 2^-24, 1 + 2^-24], so the products p that pass are the floats in
//   [(-1 - 2^-24) - beta, (1 + 2^-24) - beta], rounded inwards (formed in
//   double; for |beta| >= 2^25 only p = -beta), and fl(x w) is monotone in
//   x, so the x that give them are a run of floats, found from x = p / w by
//   stepping a float at a time (a bisection of all floats backs that up).
//   A term is then two compares (setp, the half-rate instructions) and,
//   predicated on both, dw += g x, dbeta += g and dx += g w (FMA, add,
//   FMA). On the H100, forming fl(x w) and fl(. + beta) in every term and
//   comparing |.| <= 1 was slower, whether the accumulations were
//   predicated or multiplied by a 0/1 mask. Outside the window nothing is added,
//   where the plain version adds g * 0 * w and g * 0 * x: those are +-0,
//   except that a non-finite w or x gives NaN there. The kernel reproduces
//   that apart from the loop: a non-finite w makes its row's dx NaN for
//   every m (a NaN added to the k's dx sums), a non-finite x its column's dw
//   NaN for every n (a flag per k column, set where x is staged). With a
//   non-finite g it gives the reference's fused kernel's values (which
//   selects g, then multiplies), not the plain version's.
//   A block of 256 threads owns a 32 (K) x 64 (N) tile of w and beta at a
//   time and walks M in passes of 16 rows, x and g staged with cp.async
//   into two buffers (a pass computes while the next loads). Two groups of
//   128 threads take 8 rows of a pass each; in a group a thread holds 2 k x
//   8 n of w and of the window bounds in registers with their dw and dbeta
//   sums, the two groups finding half of the bounds each (group 1
//   hands its sums to group 0 through shared memory when a tile is done, and
//   group 0 adds them in that order and writes them once). dx: each thread
//   sums its 8 n per (row, k) in registers over its 8 rows, and the 8 lanes
//   sharing a k pair meet once a pass in a butterfly reduce-scatter (14
//   shuffles and adds for 16 values: each level sends the half its partner
//   keeps). Lane l reads its rows in the order s ^ l, so the halves it keeps
//   and sends sit in fixed registers and no select is needed; it ends with
//   row l of its 8, which it adds into the block's dx sums in shared memory
//   (one owner a (row, k): no race). A block walks a range of N tiles in
//   turn, and the ranks of a cluster of up to 16 along N split the N tiles
//   between them; after a cluster barrier each rank adds its share of dx
//   rows over the ranks in rank order and writes dx. Every sum has one fixed
//   order, so dx, dw and dbeta repeat bit for bit, with no float atomics and
//   no memset. A block keeps 512 rows of dx (two blocks an SM); a larger M
//   is walked in ranges of 512 rows. A range sums its dw and dbeta from 0
//   and then adds them to the earlier ranges' sums, which the same thread
//   wrote and reads back: each term rounds against one range's partial sum,
//   not against the sum of all M so far. (Summing on from the earlier sum
//   put an error of 8.6e-3 on dw at CNV's conv1, M = 131,072, against a
//   float64 sum; ste_accuracy.py, PERF.md section 6.)
//
// Kernels 3 and 4, the split step (FUSED_BWD_DEFAULT = False): kernel 5's
// design, each kernel doing its share, sharing its window search.
//   Kernel 3 (dx) is kernel 5 without dw and dbeta: a term is the two setp
//   and, predicated on both, dx += g w (three instructions); the same tile,
//   row order, butterfly and M ranges, and by the wrapper's plan the same
//   cluster size, so its dx equals kernel 5's bit for bit. (Deciding the
//   window with one unsigned compare of order keys instead, x's key minus
//   key(xlo) below the window's width in keys, the subtract on IMAD, gave
//   the same bits more slowly on the H100: the compare pipe does not bound
//   it.)
//   Kernel 4 (dw, dbeta): a term is the two setp and dw += g x, dbeta += g
//   (four instructions). With no dx it has no butterfly, no 80 KB of dx
//   sums in shared memory and no cluster: a block a (K tile, N tile), M
//   walked in passes of 32 rows. Each group takes 8 of every 16 rows, a lane
//   reads them in the order s ^ ng, ng the octet of its columns in a
//   64-column frame, and group 1 hands its sums to group 0 at the end of an
//   M range, all as in kernel 5: every (k, n) sums in kernel 5's order, so dw
//   and dbeta equal kernel 5's bit for bit. A thread takes 8 columns (64 a
//   tile, two blocks an SM) where the K x N tiles fill the card, else 4 (32
//   a tile, 64 registers, four blocks an SM: 300 blocks at k/v where 64
//   columns give 150); the plan is the wrapper's.
//   Both write every output once in one launch, with no memset and no float
//   atomics, and repeat bit for bit; a non-finite w or x and a non-finite g
//   give what kernel 5 gives.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

namespace cg = cooperative_groups;

namespace {

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Run `set` (a kernel's cudaFuncSetAttribute calls) once per device.
template <class F>
cudaError_t once_per_device(std::atomic<uint64_t>& done, F set) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (bit && (done.load() & bit)) return cudaSuccess;
  err = set();
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

// ---------------------------------------------------------------------------
// cp.async: 16- or 4-byte copies into shared memory, zero-filled when !ok
// (the source address is then never read, but must still be valid)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool ok) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool ok) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

// ---------------------------------------------------------------------------
// Kernel 2: y = sum_k Sign(x w + beta)
// ---------------------------------------------------------------------------

namespace fwd {

constexpr int THREADS = 256;
constexpr int BM = 128, BN = 64, BK = 16, STAGES = 3;
constexpr int XS = BK + 4;  // x row stride in floats: 8 consecutive rows on 8 bank quads
constexpr int MAX_SPLITS = 8;

struct Stage {
  float x[BM][XS];
  float w[BK][BN];
  float nb[BK][BN];  // the remapped -beta
};
constexpr size_t SMEM = STAGES * sizeof(Stage);  // 55,296 bytes
static_assert(BM * BN * sizeof(float) <= SMEM, "the split counts reuse the ring");

// The threshold that fl(x w) is compared with: fl(x w) >= nb(beta) exactly
// when fl(fl(x w) + beta) >= 0 (see the header).
__device__ __forceinline__ float neg_beta(float b) {
  if (b == __int_as_float(0x7f800000)) return -FLT_MAX;           // +inf
  if (b == __int_as_float(0xff800000)) return __int_as_float(0x7fc00000);  // -inf: NaN, never >=
  return -b;                                                      // NaN stays NaN
}

// 1.0 when a >= b, else 0.0 (NaN on either side: 0.0)
__device__ __forceinline__ float ge1(float a, float b) {
  float r;
  asm("set.ge.f32.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// Issue the copies of K slice [k0, k0 + BK) of the tile into `st`; rows past
// k_end (and past M, N) are zero-filled. VEC: K % 4 == 0, N % 4 == 0 and
// 16-byte aligned operands, so every float4 lies wholly inside or outside.
template <bool VEC>
__device__ __forceinline__ void load_slice(Stage& st, const float* __restrict__ x,
                                           const float* __restrict__ w,
                                           const float* __restrict__ beta, int M, int N, int K,
                                           int m0, int n0, int k0, int k_end, int tid) {
  if (VEC) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // x: 128 rows x 4 float4
      const int q = tid + THREADS * h, r = q >> 2, c = (q & 3) * 4;
      const int m = m0 + r, k = k0 + c;
      const bool ok = m < M && k < k_end;
      cp_async16(&st.x[r][c], ok ? x + (size_t)m * K + k : x, ok);
    }
    const int r = tid >> 4, c = (tid & 15) * 4;  // w, beta: 16 rows x 16 float4
    const int k = k0 + r, n = n0 + c;
    const bool ok = k < k_end && n < N;
    const size_t off = ok ? (size_t)k * N + n : 0;
    cp_async16(&st.w[r][c], w + off, ok);
    cp_async16(&st.nb[r][c], beta + off, ok);
  } else {
#pragma unroll
    for (int h = 0; h < BM * BK / THREADS; ++h) {
      const int q = tid + THREADS * h, r = q / BK, c = q % BK;
      const int m = m0 + r, k = k0 + c;
      const bool ok = m < M && k < k_end;
      cp_async4(&st.x[r][c], ok ? x + (size_t)m * K + k : x, ok);
    }
#pragma unroll
    for (int h = 0; h < BK * BN / THREADS; ++h) {
      const int q = tid + THREADS * h, r = q / BN, c = q % BN;
      const int k = k0 + r, n = n0 + c;
      const bool ok = k < k_end && n < N;
      const size_t off = ok ? (size_t)k * N + n : 0;
      cp_async4(&st.w[r][c], w + off, ok);
      cp_async4(&st.nb[r][c], beta + off, ok);
    }
  }
}

// Turn the beta elements this thread copied into nb(beta), NaN past k_end.
// A thread sees its own cp.async data once its group has been waited on.
template <bool VEC>
__device__ __forceinline__ void remap_slice(Stage& st, int k0, int k_end, int tid) {
  if (VEC) {
    const int r = tid >> 4, c = (tid & 15) * 4;
    float4* p = reinterpret_cast<float4*>(&st.nb[r][c]);
    float4 v = *p;
    const bool in = k0 + r < k_end;
    const float nan = __int_as_float(0x7fc00000);
    v.x = in ? neg_beta(v.x) : nan;
    v.y = in ? neg_beta(v.y) : nan;
    v.z = in ? neg_beta(v.z) : nan;
    v.w = in ? neg_beta(v.w) : nan;
    *p = v;
  } else {
#pragma unroll
    for (int h = 0; h < BK * BN / THREADS; ++h) {
      const int q = tid + THREADS * h, r = q / BN, c = q % BN;
      st.nb[r][c] = k0 + r < k_end ? neg_beta(st.nb[r][c]) : __int_as_float(0x7fc00000);
    }
  }
}

// Grid (ceil(N / BN), ceil(M / BM), splits), cluster (1, 1, splits); rank z
// takes the K slices [z per, (z + 1) per) of ceil(K / BK).
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
cac_train_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ beta, float* __restrict__ y, int M, int N, int K,
                     int slices_per_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Stage* ring = reinterpret_cast<Stage*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), nsplit = (int)cluster.num_blocks();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // eight consecutive rows and four column quads a warp: rows tm + 16 i,
  // columns tn * 4 .. + 3
  const int tm = (warp & 1) * 8 + (lane & 7), tn = (warp >> 1) * 4 + (lane >> 3);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = min(K, rank * slices_per_split * BK);
  const int k_end = min(K, k_begin + slices_per_split * BK);
  const int slices = cdiv(k_end - k_begin, BK);

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < slices)
      load_slice<VEC>(ring[s], x, w, beta, M, N, K, m0, n0, k_begin + s * BK, k_end, tid);
    cp_async_commit();
  }
  for (int t = 0; t < slices; ++t) {
    cp_async_wait<STAGES - 2>();
    Stage& st = ring[t % STAGES];
    remap_slice<VEC>(st, k_begin + t * BK, k_end, tid);
    __syncthreads();  // slice t is in; every thread is done with slice t - 1
    const int next = t + STAGES - 1;
    if (next < slices)
      load_slice<VEC>(ring[next % STAGES], x, w, beta, M, N, K, m0, n0, k_begin + next * BK,
                      k_end, tid);
    cp_async_commit();
#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) {
      float4 xv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) xv[i] = *reinterpret_cast<const float4*>(&st.x[tm + 16 * i][kq]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 wv = *reinterpret_cast<const float4*>(&st.w[kq + kk][tn * 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&st.nb[kq + kk][tn * 4]);
        const float wa[4] = {wv.x, wv.y, wv.z, wv.w}, ba[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float xs = kk == 0 ? xv[i].x : kk == 1 ? xv[i].y : kk == 2 ? xv[i].z : xv[i].w;
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __fadd_rn(acc[i][j], ge1(__fmul_rn(xs, wa[j]), ba[j]));
        }
      }
    }
  }
  cp_async_wait<0>();

  if (nsplit == 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + tm + 16 * i, n = n0 + tn * 4;
      if (m >= M) continue;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = (float)(2 * (int)acc[i][j] - K);
      float* o = y + (size_t)m * N + n;
      if (VEC) {
        if (n < N) *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < N) o[j] = v[j];
      }
    }
    return;
  }
  // Splits: counts into this rank's shared memory, then rank r adds float4
  // slots [r Q / s, (r + 1) Q / s) over the ranks in rank order.
  __syncthreads();  // the ring is free
  float4* red = reinterpret_cast<float4*>(smem_raw);  // [BM][BN / 4]
#pragma unroll
  for (int i = 0; i < 8; ++i)
    red[(tm + 16 * i) * (BN / 4) + tn] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  cluster.sync();
  constexpr int Q = BM * BN / 4;
  const int lo = rank * Q / nsplit, hi = (rank + 1) * Q / nsplit;
  for (int q = lo + tid; q < hi; q += THREADS) {
    float4 v = *cluster.map_shared_rank(red + q, 0);
    for (int r = 1; r < nsplit; ++r) v = add4(v, *cluster.map_shared_rank(red + q, r));
    const int m = m0 + q / (BN / 4), n = n0 + (q % (BN / 4)) * 4;
    if (m >= M) continue;
    const float o4[4] = {(float)(2 * (int)v.x - K), (float)(2 * (int)v.y - K),
                         (float)(2 * (int)v.z - K), (float)(2 * (int)v.w - K)};
    float* o = y + (size_t)m * N + n;
    if (VEC) {
      if (n < N) *reinterpret_cast<float4*>(o) = make_float4(o4[0], o4[1], o4[2], o4[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n + j < N) o[j] = o4[j];
    }
  }
  cluster.sync();  // no rank leaves while another reads its counts
}

void config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute (&attr)[1], dim3 grid, int splits) {
  cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
}

cudaError_t allow_smem() {
  static std::atomic<uint64_t> done{0};
  return once_per_device(done, [] {
    cudaError_t err = cudaFuncSetAttribute(cac_train_fwd_kernel<true>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(cac_train_fwd_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    return err;
  });
}

}  // namespace fwd

// ---------------------------------------------------------------------------
// Kernel 5: dx, dw, dbeta from one mask
// ---------------------------------------------------------------------------

namespace fused {

constexpr int THREADS = 256;  // two groups of 4 warps, each taking 8 rows of a pass
constexpr int BK = 32, BN = 64, R = 16, HALF = R / 2, STAGES = 2;
constexpr int XS = BK + 8;   // x and dx row stride: a warp's 8 rows x 4 k pairs on 2 wavefronts
constexpr int GS = BN + 4;   // g row stride: 8 rows x 8 column octets on distinct bank quads
constexpr int MAX_ROWS = 512;  // rows of dx a block sums in shared memory (an M range)
constexpr int MAX_CLUSTER = 16;  // above 8, a non-portable cluster size (the H100 takes 16)
constexpr int SUMS = 32;  // dw and dbeta sums a thread holds: 2 k x 8 n each

struct Stage {
  float x[R][XS];
  float g[R][GS];
};

// the ring, group 1's dw and dbeta sums handed to group 0, and the dx sums
size_t smem_bytes(int rows) {
  return STAGES * sizeof(Stage) + (SUMS * THREADS / 2 + (size_t)rows * XS) * sizeof(float);
}

// Rows of dx a block keeps for an M of m: min(m, MAX_ROWS), a multiple of R.
int range_rows(int m) { return std::min(cdiv(m, R) * R, MAX_ROWS); }

__device__ __forceinline__ bool is_finite(float v) { return fabsf(v) <= FLT_MAX; }

// The STE window as bounds on the rounded product: |fl(p + b)| <= 1 exactly
// when plo <= p <= phi. Round to nearest even keeps fl(v) in [-1, 1] exactly
// for v in [-1 - 2^-24, 1 + 2^-24] (the ties round to the even +-1), so plo
// and phi are the floats nearest inside (-1 - 2^-24) - b and (1 + 2^-24) - b,
// formed in double and rounded inwards (the double difference is exact, or
// for |b| < 2^-29 off by less than 2^-53, never across a float at the
// bound); for |b| >= 2^25 the floats near -b are 4 or more apart and only
// p = -b gives a sum in [-1, 1]. A non-finite b gives NaN: no p is inside.
__device__ __forceinline__ void window_on_p(float b, float& plo, float& phi) {
  if (!is_finite(b)) {
    plo = phi = __int_as_float(0x7fc00000);
  } else if (fabsf(b) >= 33554432.f) {
    plo = phi = -b;
  } else {
    plo = __double2float_ru((-1.0 - 0x1p-24) - (double)b);
    phi = __double2float_rd((1.0 + 0x1p-24) - (double)b);
  }
}

// Floats in their order as integers (-0 just below +0; NaN not used).
__device__ __forceinline__ int order_key(float v) {
  const int i = __float_as_int(v);
  return i < 0 ? i ^ 0x7fffffff : i;
}
__device__ __forceinline__ float from_key(int k) { return __int_as_float(k < 0 ? k ^ 0x7fffffff : k); }

// The first float x in [-inf, +inf] where in(x) holds, for a predicate that
// is false and then true along the floats, from a guess near the change:
// steps one float at a time, and bisects the whole range if that is slow.
template <class In>
__device__ float first_in(float guess, In in) {
  const int lo_key = order_key(__int_as_float(0xff800000)), hi_key = order_key(__int_as_float(0x7f800000));
  int k = isnan(guess) ? 0 : order_key(guess);
  for (int step = 0; step < 8; ++step) {
    if (in(from_key(k))) {
      if (k == lo_key || !in(from_key(k - 1))) return from_key(k);
      --k;
    } else {
      if (k == hi_key) return __int_as_float(0x7fc00000);  // never
      ++k;
    }
  }
  int a = lo_key, z = hi_key;  // bisect: in(a - 1) false, in(z) true, if anywhere
  if (!in(from_key(z))) return __int_as_float(0x7fc00000);
  while (a < z) {
    const int mid = (int)(((long long)a + z) >> 1);
    if (in(from_key(mid))) z = mid; else a = mid + 1;
  }
  return from_key(a);
}

// The STE window on x: |fl(fl(x w) + b)| <= 1 exactly when xlo <= x <= xhi
// (NaN bounds: never). fl(x w) is monotone in x, so the x that put it in
// [plo, phi] are a run of floats, found from x = p / w. A zero w makes the
// product 0 for every finite x (NaN for an infinite one); a non-finite w
// or b is never inside.
__device__ __forceinline__ void window_on_x(float w, float b, float& xlo, float& xhi) {
  const float nan = __int_as_float(0x7fc00000);
  float plo, phi;
  window_on_p(b, plo, phi);
  if (isnan(plo) || !is_finite(w)) {
    xlo = xhi = nan;
  } else if (w == 0.f) {
    const bool inside = plo <= 0.f && 0.f <= phi;
    xlo = inside ? -FLT_MAX : nan;
    xhi = inside ? FLT_MAX : nan;
  } else {
    const bool up = w > 0.f;  // fl(x w) grows with x
    const float first = up ? plo : phi, last = up ? phi : plo;
    const float rw = __frcp_rn(w);  // the guesses need not be exact
    xlo = first_in(first * rw, [&](float x) {
      const float q = __fmul_rn(x, w);
      return up ? q >= plo : q <= phi;
    });
    // the last x inside is one float below the first x past it
    const float past = first_in(last * rw, [&](float x) {
      const float q = __fmul_rn(x, w);
      return up ? q > phi : q < plo;
    });
    xhi = isnan(past) ? __int_as_float(0x7f800000) : from_key(order_key(past) - 1);
  }
}

// The STE term, three predicated instructions on xlo <= x <= xhi:
// dw += g x, db += g, d += g w.
__device__ __forceinline__ void ste_term(float x, float w, float xlo, float xhi, float g,
                                         float& dw, float& db, float& d) {
  asm("{\n .reg .pred p, q;\n setp.ge.f32 p, %3, %4;\n setp.le.and.f32 q, %3, %5, p;\n"
      " @q fma.rn.f32 %0, %6, %3, %0;\n @q add.rn.f32 %1, %1, %6;\n @q fma.rn.f32 %2, %6, %7, %2;\n}"
      : "+f"(dw), "+f"(db), "+f"(d)
      : "f"(x), "f"(xlo), "f"(xhi), "f"(g), "f"(w));
}

// Copies of pass rows [mr0, mr0 + R) (clipped at m_end) of x at k0 .. k0 +
// 31 and of g at n0 .. n0 + 63. VEC: K % 4 == 0, N % 4 == 0 and 16-byte
// aligned operands.
template <bool VEC>
__device__ __forceinline__ void load_pass(Stage& st, const float* __restrict__ x,
                                          const float* __restrict__ g, int N, int K, int m_end,
                                          int mr0, int k0, int n0, int tid) {
  if (VEC) {
    if (tid < R * BK / 4) {  // x: 16 rows x 8 float4
      const int r = tid >> 3, c = (tid & 7) * 4;
      const int m = mr0 + r, k = k0 + c;
      const bool ok = m < m_end && k < K;
      cp_async16(&st.x[r][c], ok ? x + (size_t)m * K + k : x, ok);
    }
    {  // g: 16 rows x 16 float4
      const int r = tid >> 4, c = (tid & 15) * 4;
      const int m = mr0 + r, n = n0 + c;
      const bool ok = m < m_end && n < N;
      cp_async16(&st.g[r][c], ok ? g + (size_t)m * N + n : g, ok);
    }
  } else {  // rolled: unrolled, the 4-byte copies' addresses spill at 128 registers
#pragma unroll 1
    for (int h = 0; h < R * BK / THREADS; ++h) {
      const int q = tid + THREADS * h, r = q / BK, c = q % BK;
      const int m = mr0 + r, k = k0 + c;
      const bool ok = m < m_end && k < K;
      cp_async4(&st.x[r][c], ok ? x + (size_t)m * K + k : x, ok);
    }
#pragma unroll 1
    for (int h = 0; h < R * BN / THREADS; ++h) {
      const int q = tid + THREADS * h, r = q / BN, c = q % BN;
      const int m = mr0 + r, n = n0 + c;
      const bool ok = m < m_end && n < N;
      cp_async4(&st.g[r][c], ok ? g + (size_t)m * N + n : g, ok);
    }
  }
}

// Mark in xbad the k columns of the x elements this thread copied into `st`
// that are not finite (a thread sees its own cp.async data once its group
// has been waited on).
template <bool VEC>
__device__ __forceinline__ void mark_nonfinite_x(const Stage& st, int* xbad, int tid) {
  if (VEC) {
    if (tid >= R * BK / 4) return;
    const int r = tid >> 3, c = (tid & 7) * 4;
    const float4 v = *reinterpret_cast<const float4*>(&st.x[r][c]);
    if (!is_finite(v.x)) atomicOr(&xbad[c], 1);
    if (!is_finite(v.y)) atomicOr(&xbad[c + 1], 1);
    if (!is_finite(v.z)) atomicOr(&xbad[c + 2], 1);
    if (!is_finite(v.w)) atomicOr(&xbad[c + 3], 1);
  } else {
#pragma unroll
    for (int h = 0; h < R * BK / THREADS; ++h) {
      const int q = tid + THREADS * h, r = q / BK, c = q % BK;
      if (!is_finite(st.x[r][c])) atomicOr(&xbad[c], 1);
    }
  }
}

// Grid (cluster, ceil(K / BK)), cluster (cluster, 1, 1): K tile blockIdx.y;
// rank q of the cluster takes N tiles [q T / C, (q + 1) T / C) of T. `rows`
// (range_rows(M)) is the M range a block sums dx over in shared memory.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
cac_train_bwd_fused_kernel(const float* __restrict__ x, const float* __restrict__ w,
                           const float* __restrict__ beta, const float* __restrict__ g,
                           float* __restrict__ dx, float* __restrict__ dw,
                           float* __restrict__ db, int M, int N, int K, int rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int xbad[BK];  // a non-finite x in this k column (any row)
  Stage* ring = reinterpret_cast<Stage*>(smem_raw);
  // [SUMS][THREADS / 2]: a tile's window bounds, then group 1's dw and dbeta sums
  float* sums = reinterpret_cast<float*>(smem_raw + STAGES * sizeof(Stage));
  float* dxs = sums + SUMS * THREADS / 2;                                      // [rows][XS]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), nrank = (int)cluster.num_blocks();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // group `half` takes rows 8 half .. + 7 of every pass; in it, 8 lanes
  // share a k pair, k0 + 2 kg + i, and a lane owns columns n0 + 8 ng + j
  const int half = warp >> 2, kg = (warp & 3) * 4 + (lane >> 3), ng = lane & 7;
  const int gtid = tid & (THREADS / 2 - 1);
  const int k0 = blockIdx.y * BK;
  const int tiles = cdiv(N, BN);
  const int t_begin = rank * tiles / nrank, t_end = (rank + 1) * tiles / nrank;
  const int ntiles = t_end - t_begin;
  const float nan = __int_as_float(0x7fc00000);
  if (tid < BK) xbad[tid] = 0;

  for (int m_base = 0; m_base < M; m_base += rows) {
    const int m_end = min(M, m_base + rows);
    const int passes = cdiv(m_end - m_base, R);
    for (int e = tid; e < rows * XS / 4; e += THREADS)
      reinterpret_cast<float4*>(dxs)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();  // xbad and the dx sums are clear before any pass marks or adds

    const int items = ntiles * passes;  // (tile, pass) pairs, tile-major
    float wr[2][8], xlo[2][8], xhi[2][8], dwa[2][8], dba[2][8];
    float poison[2];  // NaN for a k whose w row holds a non-finite value in this tile
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < items)
        load_pass<VEC>(ring[s], x, g, N, K, m_end, m_base + (s % passes) * R, k0,
                       (t_begin + s / passes) * BN, tid);
      cp_async_commit();
    }
    for (int it = 0; it < items; ++it) {
      const int tile = t_begin + it / passes, pass = it % passes;
      const int n0 = tile * BN;
      cp_async_wait<STAGES - 2>();
      const Stage& st = ring[it % STAGES];
      mark_nonfinite_x<VEC>(st, xbad, tid);
      __syncthreads();  // pass `it` is in; every thread is done with pass it - 1
      const int next = it + STAGES - 1;
      if (next < items)
        load_pass<VEC>(ring[next % STAGES], x, g, N, K, m_end, m_base + (next % passes) * R,
                       k0, (t_begin + next / passes) * BN, tid);
      cp_async_commit();
      if (pass == 0) {  // a new N tile: its w, window bounds, and dw, dbeta so far
        // group `half` finds the bounds of columns 4 half .. + 3 of the
        // thread's 2 x 8 and hands them over in shared memory; every load
        // of the tile is issued first
        float wb[8], bb[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int i = e >> 2, j = 4 * half + (e & 3);
          const int k = k0 + 2 * kg + i, n = n0 + 8 * ng + j;
          const bool ok = k < K && n < N;
          const size_t o = ok ? (size_t)k * N + n : 0;
          wb[e] = ok ? w[o] : 0.f;
          bb[e] = ok ? beta[o] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int k = k0 + 2 * kg + i;
          int bad = 0;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int n = n0 + 8 * ng + j;
            const bool ok = k < K && n < N;
            const size_t o = (size_t)k * N + n;
            wr[i][j] = ok ? w[o] : 0.f;
            dwa[i][j] = 0.f;  // a range's sums start at 0 (see the write-out)
            dba[i][j] = 0.f;
            bad |= !is_finite(wr[i][j]);
          }
          bad |= __shfl_xor_sync(0xffffffffu, bad, 1);
          bad |= __shfl_xor_sync(0xffffffffu, bad, 2);
          bad |= __shfl_xor_sync(0xffffffffu, bad, 4);
          poison[i] = bad ? nan : 0.f;
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int i = e >> 2, j = 4 * half + (e & 3);
          window_on_x(wb[e], bb[e], sums[(8 * i + j) * (THREADS / 2) + gtid],
                      sums[(16 + 8 * i + j) * (THREADS / 2) + gtid]);
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            xlo[i][j] = sums[(8 * i + j) * (THREADS / 2) + gtid];
            xhi[i][j] = sums[(16 + 8 * i + j) * (THREADS / 2) + gtid];
          }
      }

      float dxp[HALF][2];  // slot s: this lane's row 8 half + (s ^ ng), summed over its 8 n
#pragma unroll
      for (int s = 0; s < HALF; ++s) {
        const int r = HALF * half + (s ^ ng);
        const float2 xv = *reinterpret_cast<const float2*>(&st.x[r][2 * kg]);
        const float4 g0 = *reinterpret_cast<const float4*>(&st.g[r][8 * ng]);
        const float4 g1 = *reinterpret_cast<const float4*>(&st.g[r][8 * ng + 4]);
        const float xa[2] = {xv.x, xv.y};
        const float ga[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          dxp[s][i] = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            ste_term(xa[i], wr[i][j], xlo[i][j], xhi[i][j], ga[j], dwa[i][j], dba[i][j], dxp[s][i]);
        }
      }
      // Butterfly reduce-scatter over the 8 lanes of the k pair: at level b a
      // lane keeps the slots with bit b clear and adds its partner's slot
      // s | 2^b, which holds the same row (rows are s ^ lane). Slot 0 ends
      // with row 8 half + ng summed over the tile's 64 columns.
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const int off = 1 << b;
#pragma unroll
        for (int s = 0; s < HALF; s += 2 * off)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            dxp[s][i] = __fadd_rn(dxp[s][i], __shfl_xor_sync(0xffffffffu, dxp[s + off][i], off));
      }
      {
        float2* acc =
            reinterpret_cast<float2*>(&dxs[(pass * R + HALF * half + ng) * XS + 2 * kg]);
        float2 v = *acc;
        v.x = __fadd_rn(__fadd_rn(v.x, dxp[0][0]), poison[0]);
        v.y = __fadd_rn(__fadd_rn(v.y, dxp[0][1]), poison[1]);
        *acc = v;
      }

      if (pass == passes - 1) {  // the tile's M range is done: dw, dbeta out
        // group 1 hands its sums to group 0, which adds them to its own
        __syncthreads();  // every thread has its window bounds out of `sums`
        if (half == 1) {
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              sums[(8 * i + j) * (THREADS / 2) + gtid] = dwa[i][j];
              sums[(16 + 8 * i + j) * (THREADS / 2) + gtid] = dba[i][j];
            }
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (half == 1) break;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            dwa[i][j] = __fadd_rn(dwa[i][j], sums[(8 * i + j) * (THREADS / 2) + gtid]);
            dba[i][j] = __fadd_rn(dba[i][j], sums[(16 + 8 * i + j) * (THREADS / 2) + gtid]);
          }
          const int k = k0 + 2 * kg + i, n = n0 + 8 * ng;
          if (k >= K) continue;
          const bool xnan = xbad[2 * kg + i] != 0;  // g 0 x with x non-finite: NaN
          float* pw = dw + (size_t)k * N + n;
          float* pb = db + (size_t)k * N + n;
          if (m_base > 0) {  // the earlier ranges' sums, which this thread wrote
#pragma unroll
            for (int j = 0; j < 8; ++j)
              if (n + j < N) {
                dwa[i][j] = __fadd_rn(pw[j], dwa[i][j]);
                dba[i][j] = __fadd_rn(pb[j], dba[i][j]);
              }
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) dwa[i][j] = xnan ? nan : dwa[i][j];
          if (VEC) {
#pragma unroll
            for (int h = 0; h < 2; ++h)
              if (n + 4 * h < N) {
                *reinterpret_cast<float4*>(pw + 4 * h) =
                    make_float4(dwa[i][4 * h], dwa[i][4 * h + 1], dwa[i][4 * h + 2], dwa[i][4 * h + 3]);
                *reinterpret_cast<float4*>(pb + 4 * h) =
                    make_float4(dba[i][4 * h], dba[i][4 * h + 1], dba[i][4 * h + 2], dba[i][4 * h + 3]);
              }
          } else {
#pragma unroll
            for (int j = 0; j < 8; ++j)
              if (n + j < N) {
                pw[j] = dwa[i][j];
                pb[j] = dba[i][j];
              }
          }
        }
      }
    }
    cp_async_wait<0>();
    // dx of the range: rank q adds rows [q rows / C, (q + 1) rows / C) over
    // the ranks in rank order
    cluster.sync();
    const int nrow = m_end - m_base;
    const int lo = rank * nrow / nrank, hi = (rank + 1) * nrow / nrank;
    for (int e = lo * (BK / 4) + tid; e < hi * (BK / 4); e += THREADS) {
      const int r = e / (BK / 4), c = (e % (BK / 4)) * 4;
      const float* p = &dxs[r * XS + c];
      float4 v = *reinterpret_cast<const float4*>(cluster.map_shared_rank(p, 0));
      for (int q = 1; q < nrank; ++q)
        v = add4(v, *reinterpret_cast<const float4*>(cluster.map_shared_rank(p, q)));
      const int k = k0 + c;
      float* o = dx + (size_t)(m_base + r) * K + k;
      if (VEC) {
        if (k < K) *reinterpret_cast<float4*>(o) = v;
      } else {
        const float va[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k + j < K) o[j] = va[j];
      }
    }
    cluster.sync();  // no rank leaves or clears its dx sums while another reads them
  }
}

void config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute (&attr)[1], dim3 grid, int cluster,
            int rows) {
  cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes(rows);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
}

cudaError_t allow_smem() {
  static std::atomic<uint64_t> done{0};
  return once_per_device(done, [] {
    const int most = (int)smem_bytes(MAX_ROWS);
    cudaError_t err = cudaSuccess;
    for (auto kernel : {cac_train_bwd_fused_kernel<true>, cac_train_bwd_fused_kernel<false>}) {
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    return err;
  });
}

}  // namespace fused

// ---------------------------------------------------------------------------
// Kernels 3 and 4: dx alone, and dw and dbeta alone, on kernel 5's design
// ---------------------------------------------------------------------------

namespace split {

using fused::BK;
using fused::MAX_CLUSTER;
using fused::MAX_ROWS;
using fused::STAGES;
using fused::THREADS;
using fused::XS;
using fused::is_finite;
constexpr int DX_RP = 16, DW_RP = 32;  // rows a pass of kernels 3 and 4

// A tile of 8 NT columns (a thread takes NT of them) walked in passes of RP
// rows, each group taking 8 of every 16.
template <int NT, int RP>
struct Tile {
  static constexpr int BN = 8 * NT;
  // g row stride: the 8 lanes of a k pair read 8 rows (NT 8) or 4 rows, two
  // lanes each (NT 4), and their column quads land on distinct bank quads
  static constexpr int GS = NT == 8 ? BN + 4 : BN;
  // floats a thread of a group hands the other: 2 k x NT window bounds, or
  // its dw and dbeta sums
  static constexpr int SUMS = 4 * NT;
  struct Stage {
    float x[RP][XS];
    float g[RP][GS];
  };
  // the ring, the handover area of `sums`, and (with dx) the dx sums
  static size_t smem_bytes(bool with_dx, int rows) {
    return STAGES * sizeof(Stage) +
           (SUMS * THREADS / 2 + (with_dx ? (size_t)rows * XS : 0)) * sizeof(float);
  }
};

// Rows of an M range for an M of m: min(m, MAX_ROWS), a multiple of rp.
int range_rows(int m, int rp) { return std::min(cdiv(m, rp) * rp, MAX_ROWS); }

// The STE term, predicated on xlo <= x <= xhi (two setp): kernel 3 adds d
// += g w, kernel 4 dw += g x and db += g (kernel 5's operations, operand
// for operand).
template <bool DX>
__device__ __forceinline__ void ste_term(float x, float w, float xlo, float xhi, float g,
                                         float& dw, float& db, float& d) {
  if constexpr (DX) {
    asm("{\n .reg .pred p, q;\n setp.ge.f32 p, %1, %2;\n setp.le.and.f32 q, %1, %3, p;\n"
        " @q fma.rn.f32 %0, %4, %5, %0;\n}"
        : "+f"(d)
        : "f"(x), "f"(xlo), "f"(xhi), "f"(g), "f"(w));
  } else {
    asm("{\n .reg .pred p, q;\n setp.ge.f32 p, %2, %3;\n setp.le.and.f32 q, %2, %4, p;\n"
        " @q fma.rn.f32 %0, %5, %2, %0;\n @q add.rn.f32 %1, %1, %5;\n}"
        : "+f"(dw), "+f"(db)
        : "f"(x), "f"(xlo), "f"(xhi), "f"(g));
  }
}

// Copies of pass rows [mr0, mr0 + RP) (clipped at m_end) of x at k0 .. k0
// + 31 and of g at n0 .. n0 + BN - 1. VEC: K % 4 == 0, N % 4 == 0 and
// 16-byte aligned operands.
template <bool VEC, int NT, int RP>
__device__ __forceinline__ void load_pass(typename Tile<NT, RP>::Stage& st,
                                          const float* __restrict__ x,
                                          const float* __restrict__ g, int N, int K, int m_end,
                                          int mr0, int k0, int n0, int tid) {
  constexpr int BN = Tile<NT, RP>::BN;
  if (VEC) {
#pragma unroll
    for (int e = tid; e < RP * BK / 4; e += THREADS) {  // x: RP rows x 8 float4
      const int r = e >> 3, c = (e & 7) * 4;
      const int m = mr0 + r, k = k0 + c;
      const bool ok = m < m_end && k < K;
      cp_async16(&st.x[r][c], ok ? x + (size_t)m * K + k : x, ok);
    }
#pragma unroll
    for (int e = tid; e < RP * BN / 4; e += THREADS) {  // g: RP rows x BN / 4 float4
      const int r = e / (BN / 4), c = (e % (BN / 4)) * 4;
      const int m = mr0 + r, n = n0 + c;
      const bool ok = m < m_end && n < N;
      cp_async16(&st.g[r][c], ok ? g + (size_t)m * N + n : g, ok);
    }
  } else {  // rolled: unrolled, the 4-byte copies' addresses spill
#pragma unroll 1
    for (int e = tid; e < RP * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int m = mr0 + r, k = k0 + c;
      const bool ok = m < m_end && k < K;
      cp_async4(&st.x[r][c], ok ? x + (size_t)m * K + k : x, ok);
    }
#pragma unroll 1
    for (int e = tid; e < RP * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const int m = mr0 + r, n = n0 + c;
      const bool ok = m < m_end && n < N;
      cp_async4(&st.g[r][c], ok ? g + (size_t)m * N + n : g, ok);
    }
  }
}

// Mark in xbad the k columns of the x elements this thread copied into `st`
// that are not finite (a thread sees its own cp.async data once its group
// has been waited on).
template <bool VEC, int NT, int RP>
__device__ __forceinline__ void mark_nonfinite_x(const typename Tile<NT, RP>::Stage& st,
                                                 int* xbad, int tid) {
  if (VEC) {
#pragma unroll
    for (int e = tid; e < RP * BK / 4; e += THREADS) {
      const float4 v = *reinterpret_cast<const float4*>(&st.x[e >> 3][(e & 7) * 4]);
      const int c = (e & 7) * 4;
      if (!is_finite(v.x)) atomicOr(&xbad[c], 1);
      if (!is_finite(v.y)) atomicOr(&xbad[c + 1], 1);
      if (!is_finite(v.z)) atomicOr(&xbad[c + 2], 1);
      if (!is_finite(v.w)) atomicOr(&xbad[c + 3], 1);
    }
  } else {
#pragma unroll 1
    for (int e = tid; e < RP * BK; e += THREADS)
      if (!is_finite(st.x[e / BK][e % BK])) atomicOr(&xbad[e % BK], 1);
  }
}

// The body of kernel 3 (DX: dx) and kernel 4 (dw and dbeta), with NT
// columns a thread and RP rows a pass. Grid (parts, ceil(K / BK)): K tile
// blockIdx.y; part q of the parts takes N tiles [q T / P, (q + 1) T / P) of
// T. With dx the parts are the ranks of one cluster, which add their dx sums
// in rank order. `rows` (range_rows(M, RP)) is the M range a block walks
// before it writes dx, or dw and dbeta.
template <bool VEC, bool DX, int NT, int RP>
__device__ __forceinline__ void body(const float* __restrict__ x, const float* __restrict__ w,
                                     const float* __restrict__ beta, const float* __restrict__ g,
                                     float* __restrict__ dx, float* __restrict__ dw,
                                     float* __restrict__ db, int M, int N, int K, int rows) {
  using T = Tile<NT, RP>;
  using Stage = typename T::Stage;
  constexpr int BN = T::BN, SUMS = T::SUMS, HN = NT / 2;
  static_assert(!DX || NT == 8, "the dx butterfly takes 8 columns a lane");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int xbad[BK];  // a non-finite x in this k column (any row), with dw
  Stage* ring = reinterpret_cast<Stage*>(smem_raw);
  // [SUMS][THREADS / 2]: a tile's window bounds, then group 1's dw and dbeta sums
  float* sums = reinterpret_cast<float*>(smem_raw + STAGES * sizeof(Stage));
  float* dxs = sums + SUMS * THREADS / 2;  // [rows][XS], with dx
  cg::cluster_group cluster = cg::this_cluster();
  const int part = DX ? (int)cluster.block_rank() : (int)blockIdx.x;
  const int parts = DX ? (int)cluster.num_blocks() : (int)gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // group `half` takes rows 8 half .. + 7 of every 16 of a pass; in it, 8
  // lanes share a k pair, k0 + 2 kg + i, and lane h = lane & 7 owns columns
  // n0 + NT h + j
  const int half = warp >> 2, kg = (warp & 3) * 4 + (lane >> 3), h = lane & 7;
  const int gtid = tid & (THREADS / 2 - 1);
  const int k0 = blockIdx.y * BK;
  const int tiles = cdiv(N, BN);
  const int t_begin = part * tiles / parts, t_end = (part + 1) * tiles / parts;
  const int ntiles = t_end - t_begin;
  const float nan = __int_as_float(0x7fc00000);
  if (!DX && tid < BK) xbad[tid] = 0;

  for (int m_base = 0; m_base < M; m_base += rows) {
    const int m_end = min(M, m_base + rows);
    const int passes = cdiv(m_end - m_base, RP);
    if (DX)
      for (int e = tid; e < rows * XS / 4; e += THREADS)
        reinterpret_cast<float4*>(dxs)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();  // xbad and the dx sums are clear before any pass marks or adds

    const int items = ntiles * passes;  // (tile, pass) pairs, tile-major
    float wr[2][NT], xlo[2][NT], xhi[2][NT], dwa[2][NT], dba[2][NT];
    float poison[2];  // NaN for a k whose w row holds a non-finite value in this tile
    // A lane reads its group's rows of each 16 in the order s ^ ng, ng the
    // octet of its columns in a 64-column frame: h at NT 8 (which the dx
    // butterfly relies on), at NT 4 set per tile. So every (k, n) sums its
    // rows in kernel 5's order.
    int ng = h;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < items)
        load_pass<VEC, NT, RP>(ring[s], x, g, N, K, m_end, m_base + (s % passes) * RP, k0,
                               (t_begin + s / passes) * BN, tid);
      cp_async_commit();
    }
    for (int it = 0; it < items; ++it) {
      const int tile = t_begin + it / passes, pass = it % passes;
      const int n0 = tile * BN;
      cp_async_wait<STAGES - 2>();
      const Stage& st = ring[it % STAGES];
      if (!DX) mark_nonfinite_x<VEC, NT, RP>(st, xbad, tid);
      __syncthreads();  // pass `it` is in; every thread is done with pass it - 1
      const int next = it + STAGES - 1;
      if (next < items)
        load_pass<VEC, NT, RP>(ring[next % STAGES], x, g, N, K, m_end,
                               m_base + (next % passes) * RP, k0, (t_begin + next / passes) * BN,
                               tid);
      cp_async_commit();
      if (pass == 0) {  // a new N tile: its w, window bounds, and dw, dbeta so far
        if (NT == 4) ng = ((tile & 1) << 2) + (h >> 1);
        // group `half` finds the bounds of columns HN half .. + HN - 1 of
        // the thread's 2 x NT and hands them over in shared memory; every
        // load of the tile is issued first
        float wb[NT], bb[NT];
#pragma unroll
        for (int e = 0; e < NT; ++e) {
          const int i = e / HN, j = HN * half + e % HN;
          const int k = k0 + 2 * kg + i, n = n0 + NT * h + j;
          const bool ok = k < K && n < N;
          const size_t o = ok ? (size_t)k * N + n : 0;
          wb[e] = ok ? w[o] : 0.f;
          bb[e] = ok ? beta[o] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int k = k0 + 2 * kg + i;
          int bad = 0;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int n = n0 + NT * h + j;
            const bool ok = k < K && n < N;
            const size_t o = (size_t)k * N + n;
            wr[i][j] = DX && ok ? w[o] : 0.f;
            dwa[i][j] = 0.f;  // a range's sums start at 0, as kernel 5's
            dba[i][j] = 0.f;
            bad |= !is_finite(wr[i][j]);
          }
          if (DX) {
            bad |= __shfl_xor_sync(0xffffffffu, bad, 1);
            bad |= __shfl_xor_sync(0xffffffffu, bad, 2);
            bad |= __shfl_xor_sync(0xffffffffu, bad, 4);
            poison[i] = bad ? nan : 0.f;
          }
        }
#pragma unroll
        for (int e = 0; e < NT; ++e) {
          const int i = e / HN, j = HN * half + e % HN;
          fused::window_on_x(wb[e], bb[e], sums[(NT * i + j) * (THREADS / 2) + gtid],
                             sums[(2 * NT + NT * i + j) * (THREADS / 2) + gtid]);
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            xlo[i][j] = sums[(NT * i + j) * (THREADS / 2) + gtid];
            xhi[i][j] = sums[(2 * NT + NT * i + j) * (THREADS / 2) + gtid];
          }
      }

#pragma unroll
      for (int q = 0; q < RP / 16; ++q) {  // the pass's 16-row slices
        float dxp[8][2];  // slot s: this lane's row 16 q + 8 half + (s ^ h), summed over its 8 n
#pragma unroll
        for (int s = 0; s < 8; ++s) {
          const int r = 16 * q + 8 * half + (s ^ ng);
          const float2 xv = *reinterpret_cast<const float2*>(&st.x[r][2 * kg]);
          float ga[NT];
#pragma unroll
          for (int v = 0; v < NT / 4; ++v) {
            const float4 gv = *reinterpret_cast<const float4*>(&st.g[r][NT * h + 4 * v]);
            ga[4 * v] = gv.x;
            ga[4 * v + 1] = gv.y;
            ga[4 * v + 2] = gv.z;
            ga[4 * v + 3] = gv.w;
          }
          const float xa[2] = {xv.x, xv.y};
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            dxp[s][i] = 0.f;
#pragma unroll
            for (int j = 0; j < NT; ++j)
              ste_term<DX>(xa[i], wr[i][j], xlo[i][j], xhi[i][j], ga[j], dwa[i][j], dba[i][j],
                           dxp[s][i]);
          }
        }
        if (DX) {
          // kernel 5's butterfly reduce-scatter over the 8 lanes of the k
          // pair: slot 0 ends with row 16 q + 8 half + h summed over the
          // tile's 64 columns
#pragma unroll
          for (int b = 0; b < 3; ++b) {
            const int off = 1 << b;
#pragma unroll
            for (int s = 0; s < 8; s += 2 * off)
#pragma unroll
              for (int i = 0; i < 2; ++i)
                dxp[s][i] =
                    __fadd_rn(dxp[s][i], __shfl_xor_sync(0xffffffffu, dxp[s + off][i], off));
          }
          float2* acc = reinterpret_cast<float2*>(
              &dxs[(pass * RP + 16 * q + 8 * half + h) * XS + 2 * kg]);
          float2 v = *acc;
          v.x = __fadd_rn(__fadd_rn(v.x, dxp[0][0]), poison[0]);
          v.y = __fadd_rn(__fadd_rn(v.y, dxp[0][1]), poison[1]);
          *acc = v;
        }
      }

      if (!DX && pass == passes - 1) {  // the tile's M range is done: dw, dbeta out
        // group 1 hands its sums to group 0, which adds them to its own
        __syncthreads();  // every thread has its window bounds out of `sums`
        if (half == 1) {
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              sums[(NT * i + j) * (THREADS / 2) + gtid] = dwa[i][j];
              sums[(2 * NT + NT * i + j) * (THREADS / 2) + gtid] = dba[i][j];
            }
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (half == 1) break;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            dwa[i][j] = __fadd_rn(dwa[i][j], sums[(NT * i + j) * (THREADS / 2) + gtid]);
            dba[i][j] = __fadd_rn(dba[i][j], sums[(2 * NT + NT * i + j) * (THREADS / 2) + gtid]);
          }
          const int k = k0 + 2 * kg + i, n = n0 + NT * h;
          if (k >= K) continue;
          const bool xnan = xbad[2 * kg + i] != 0;  // g 0 x with x non-finite: NaN
          float* pw = dw + (size_t)k * N + n;
          float* pb = db + (size_t)k * N + n;
          if (m_base > 0) {  // the earlier ranges' sums, which this thread wrote
#pragma unroll
            for (int j = 0; j < NT; ++j)
              if (n + j < N) {
                dwa[i][j] = __fadd_rn(pw[j], dwa[i][j]);
                dba[i][j] = __fadd_rn(pb[j], dba[i][j]);
              }
          }
#pragma unroll
          for (int j = 0; j < NT; ++j) dwa[i][j] = xnan ? nan : dwa[i][j];
          if (VEC) {
#pragma unroll
            for (int v = 0; v < NT / 4; ++v)
              if (n + 4 * v < N) {
                *reinterpret_cast<float4*>(pw + 4 * v) =
                    make_float4(dwa[i][4 * v], dwa[i][4 * v + 1], dwa[i][4 * v + 2], dwa[i][4 * v + 3]);
                *reinterpret_cast<float4*>(pb + 4 * v) =
                    make_float4(dba[i][4 * v], dba[i][4 * v + 1], dba[i][4 * v + 2], dba[i][4 * v + 3]);
              }
          } else {
#pragma unroll
            for (int j = 0; j < NT; ++j)
              if (n + j < N) {
                pw[j] = dwa[i][j];
                pb[j] = dba[i][j];
              }
          }
        }
      }
    }
    cp_async_wait<0>();
    if (DX) {
      // dx of the range: rank q adds rows [q rows / C, (q + 1) rows / C) over
      // the ranks in rank order
      cluster.sync();
      const int nrow = m_end - m_base;
      const int lo = part * nrow / parts, hi = (part + 1) * nrow / parts;
      for (int e = lo * (BK / 4) + tid; e < hi * (BK / 4); e += THREADS) {
        const int r = e / (BK / 4), c = (e % (BK / 4)) * 4;
        const float* p = &dxs[r * XS + c];
        float4 v = *reinterpret_cast<const float4*>(cluster.map_shared_rank(p, 0));
        for (int q = 1; q < parts; ++q)
          v = add4(v, *reinterpret_cast<const float4*>(cluster.map_shared_rank(p, q)));
        const int k = k0 + c;
        float* o = dx + (size_t)(m_base + r) * K + k;
        if (VEC) {
          if (k < K) *reinterpret_cast<float4*>(o) = v;
        } else {
          const float va[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (k + j < K) o[j] = va[j];
        }
      }
      cluster.sync();  // no rank leaves or clears its dx sums while another reads them
    }
  }
}

#define SPLIT_ARGS                                                                         \
  const float *__restrict__ x, const float *__restrict__ w, const float *__restrict__ beta, \
      const float *__restrict__ g, float *__restrict__ dx, float *__restrict__ dw,         \
      float *__restrict__ db, int M, int N, int K, int rows

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2) cac_train_bwd_dx_kernel(SPLIT_ARGS) {
  body<VEC, true, 8, DX_RP>(x, w, beta, g, dx, dw, db, M, N, K, rows);
}

// kernel 4 at NT 8 (64-column tiles, two blocks an SM) or NT 4 (32-column
// tiles, 64 registers: four blocks an SM)
template <bool VEC, int NT>
__global__ void __launch_bounds__(THREADS, NT == 4 ? 4 : 2) cac_train_bwd_dw_kernel(SPLIT_ARGS) {
  body<VEC, false, NT, DW_RP>(x, w, beta, g, dx, dw, db, M, N, K, rows);
}

#undef SPLIT_ARGS

using Kernel = void (*)(const float*, const float*, const float*, const float*, float*, float*,
                        float*, int, int, int, int);

// The launch shape of kernel 3 (DX) or 4 (NT 4 or 8).
template <bool DX, int NT>
struct Launch {
  static constexpr int RP = DX ? DX_RP : DW_RP;
  using T = Tile<NT, RP>;
  static Kernel kernel(bool vec) {
    if constexpr (DX)
      return vec ? cac_train_bwd_dx_kernel<true> : cac_train_bwd_dx_kernel<false>;
    else
      return vec ? cac_train_bwd_dw_kernel<true, NT> : cac_train_bwd_dw_kernel<false, NT>;
  }
  static size_t smem(int rows) { return T::smem_bytes(DX, rows); }
};

// Grid `grid`, a cluster of `cluster` along x (kernel 3), none (cluster 0).
void config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute (&attr)[1], dim3 grid, int cluster,
            size_t smem) {
  cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 0 ? 1 : 0;
}

template <bool DX, int NT>
cudaError_t allow_smem() {
  using L = Launch<DX, NT>;
  static std::atomic<uint64_t> done{0};
  return once_per_device(done, [] {
    const int most = (int)L::smem(MAX_ROWS);
    cudaError_t err = cudaSuccess;
    for (Kernel kernel : {L::kernel(true), L::kernel(false)}) {
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
      if (DX && err == cudaSuccess)
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    return err;
  });
}

// Blocks the current card keeps resident at an M of m: in clusters of
// `cluster` (kernel 3), or in all (kernel 4; cluster ignored); -1 if it
// cannot say or an argument is out of range.
template <bool DX, int NT>
int max_blocks(int cluster, int m) {
  using L = Launch<DX, NT>;
  if (m <= 0 || (DX && (cluster < 1 || cluster > MAX_CLUSTER)) ||
      allow_smem<DX, NT>() != cudaSuccess)
    return -1;
  const size_t smem = L::smem(range_rows(m, L::RP));
  if (!DX) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, L::kernel(true), THREADS, smem) !=
            cudaSuccess)
      return -1;
    return per_sm * sms;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  config(cfg, attr, dim3(cluster, 1, 1), cluster, smem);
  int clusters = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, L::kernel(true), &cfg);
  return err == cudaSuccess ? clusters * cluster : -1;
}

// Launch kernel 3 or 4 with the N tiles split over `parts` blocks (a
// cluster with dx; at most one per N tile).
template <bool DX, int NT>
int launch(const void* x, const void* w, const void* beta, const void* g, void* dx, void* dw,
           void* db, int M, int N, int K, int parts, void* stream) {
  using L = Launch<DX, NT>;
  if (M <= 0 || N <= 0 || K <= 0 || parts < 1 || parts > cdiv(N, L::T::BN) ||
      (DX ? parts > MAX_CLUSTER || !dx : !dw || !db))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem<DX, NT>();
  if (err != cudaSuccess) return (int)err;
  const bool vec = K % 4 == 0 && N % 4 == 0 && aligned16(x) && aligned16(w) && aligned16(beta) &&
                   aligned16(g) && aligned16(dx) && aligned16(dw) && aligned16(db);
  const int rows = range_rows(M, L::RP);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  config(cfg, attr, dim3(parts, cdiv(K, BK), 1), DX ? parts : 0, L::smem(rows));
  cfg.stream = static_cast<cudaStream_t>(stream);
  err = cudaLaunchKernelEx(&cfg, L::kernel(vec), static_cast<const float*>(x),
                           static_cast<const float*>(w), static_cast<const float*>(beta),
                           static_cast<const float*>(g), static_cast<float*>(dx),
                           static_cast<float*>(dw), static_cast<float*>(db), M, N, K, rows);
  return (int)err;
}

}  // namespace split

}  // namespace

// How many blocks of kernel 2 the current card keeps resident in clusters
// of `splits`; -1 if it cannot say or splits is out of range.
extern "C" int cac_train_fwd_max_blocks(int splits) {
  if (splits < 1 || splits > fwd::MAX_SPLITS || fwd::allow_smem() != cudaSuccess) return -1;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  fwd::config(cfg, attr, dim3(1, 1, splits), splits);
  int clusters = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveClusters(&clusters, fwd::cac_train_fwd_kernel<true>, &cfg);
  return err == cudaSuccess ? clusters * splits : -1;
}

// Kernel 2. x (M, K), w and beta (K, N) -> y (M, N), all float32, with K
// split over a cluster of `splits` blocks (the wrapper's plan; no split may
// be empty). Writes every element of y once; launches on `stream`, does not
// synchronise, returns cudaErrorInvalidValue for a shape or plan it does not
// take, else the launch's error.
extern "C" int cac_train_fwd_launch(const void* x, const void* w, const void* beta, void* y,
                                    int M, int N, int K, int splits, void* stream) {
  // float32 holds every count exactly only while |y| <= K < 2^24
  if (M <= 0 || N <= 0 || K <= 0 || K >= (1 << 24) || splits < 1 || splits > fwd::MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  const int slices = cdiv(K, fwd::BK), per = cdiv(slices, splits);
  if (cdiv(slices, per) != splits) return (int)cudaErrorInvalidValue;  // an empty split
  cudaError_t err = fwd::allow_smem();
  if (err != cudaSuccess) return (int)err;
  const bool vec = K % 4 == 0 && N % 4 == 0 && aligned16(x) && aligned16(w) && aligned16(beta) &&
                   aligned16(y);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  fwd::config(cfg, attr, dim3(cdiv(N, fwd::BN), cdiv(M, fwd::BM), splits), splits);
  cfg.stream = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(beta);
  float* yf = static_cast<float*>(y);
  err = vec ? cudaLaunchKernelEx(&cfg, fwd::cac_train_fwd_kernel<true>, xf, wf, bf, yf, M, N, K, per)
            : cudaLaunchKernelEx(&cfg, fwd::cac_train_fwd_kernel<false>, xf, wf, bf, yf, M, N, K,
                                 per);
  return (int)err;
}

// How many blocks of kernel 5 at an M of m the current card keeps resident
// in clusters of `cluster`; -1 if it cannot say or an argument is out of range.
extern "C" int cac_train_bwd_fused_max_blocks(int cluster, int m) {
  if (cluster < 1 || cluster > fused::MAX_CLUSTER || m <= 0 || fused::allow_smem() != cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  fused::config(cfg, attr, dim3(cluster, 1, 1), cluster, fused::range_rows(m));
  int clusters = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveClusters(&clusters, fused::cac_train_bwd_fused_kernel<true>, &cfg);
  return err == cudaSuccess ? clusters * cluster : -1;
}

// Kernel 5. x (M, K), w and beta (K, N), g (M, N) float32 -> dx (M, K), dw
// and db (K, N), with the N tiles split over a cluster of `cluster` blocks
// (the wrapper's plan; at most one rank per N tile). Writes every output
// element once (M <= 512; above, dw and db once per 512-row range, by the
// same thread); launches on `stream`, does not synchronise, returns
// cudaErrorInvalidValue for a shape or plan it does not take, else the
// launch's error.
extern "C" int cac_train_bwd_fused_launch(const void* x, const void* w, const void* beta,
                                          const void* g, void* dx, void* dw, void* db, int M,
                                          int N, int K, int cluster, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || cluster < 1 || cluster > fused::MAX_CLUSTER ||
      cluster > cdiv(N, fused::BN) || !dx || !dw || !db)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = fused::allow_smem();
  if (err != cudaSuccess) return (int)err;
  const bool vec = K % 4 == 0 && N % 4 == 0 && aligned16(x) && aligned16(w) && aligned16(beta) &&
                   aligned16(g) && aligned16(dx) && aligned16(dw) && aligned16(db);
  const int rows = fused::range_rows(M);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  fused::config(cfg, attr, dim3(cluster, cdiv(K, fused::BK), 1), cluster, rows);
  cfg.stream = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(beta);
  const float* gf = static_cast<const float*>(g);
  float* dxf = static_cast<float*>(dx);
  float* dwf = static_cast<float*>(dw);
  float* dbf = static_cast<float*>(db);
  err = vec ? cudaLaunchKernelEx(&cfg, fused::cac_train_bwd_fused_kernel<true>, xf, wf, bf, gf,
                                 dxf, dwf, dbf, M, N, K, rows)
            : cudaLaunchKernelEx(&cfg, fused::cac_train_bwd_fused_kernel<false>, xf, wf, bf, gf,
                                 dxf, dwf, dbf, M, N, K, rows);
  return (int)err;
}

// How many blocks of kernel 3 at an M of m the current card keeps
// resident in clusters of `cluster`; -1 if it cannot say or an argument is
// out of range.
extern "C" int cac_train_bwd_dx_max_blocks(int cluster, int m) {
  return split::max_blocks<true, 8>(cluster, m);
}

// How many blocks of kernel 4 with `nt` columns a thread (4 or 8) at an M
// of m the current card keeps resident (no cluster); -1 if it cannot say or
// an argument is out of range.
extern "C" int cac_train_bwd_dw_max_blocks(int nt, int m) {
  return nt == 4 ? split::max_blocks<false, 4>(0, m)
                 : nt == 8 ? split::max_blocks<false, 8>(0, m) : -1;
}

// Kernel 3. x (M, K), w and beta (K, N), g (M, N) float32 -> dx (M, K),
// the N tiles split over a cluster of `cluster` blocks (the wrapper's plan,
// kernel 5's; at most one rank per N tile). Writes every element once, in
// kernel 5's order; launches on `stream`, does not synchronise, returns
// cudaErrorInvalidValue for a shape or plan it does not take, else the
// launch's error.
extern "C" int cac_train_bwd_dx_launch(const void* x, const void* w, const void* beta,
                                       const void* g, void* dx, int M, int N, int K, int cluster,
                                       void* stream) {
  return split::launch<true, 8>(x, w, beta, g, dx, nullptr, nullptr, M, N, K, cluster, stream);
}

// Kernel 4. x (M, K), w and beta (K, N), g (M, N) float32 -> dw and db (K,
// N), with `nt` columns a thread (4 or 8: 32- or 64-column N tiles) and the
// N tiles split over `parts` blocks a K tile (the wrapper's plan; at most
// one block per N tile). Writes every element once (M <= 512; above, once
// per 512-row range, by the same thread), in kernel 5's order; launches on
// `stream`, does not synchronise, returns cudaErrorInvalidValue for a shape
// or plan it does not take, else the launch's error.
extern "C" int cac_train_bwd_dw_launch(const void* x, const void* w, const void* beta,
                                       const void* g, void* dw, void* db, int M, int N, int K,
                                       int nt, int parts, void* stream) {
  if (nt == 4)
    return split::launch<false, 4>(x, w, beta, g, nullptr, dw, db, M, N, K, parts, stream);
  if (nt == 8)
    return split::launch<false, 8>(x, w, beta, g, nullptr, dw, db, M, N, K, parts, stream);
  return (int)cudaErrorInvalidValue;
}
