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
// Kernel 6 has two routes, chosen by the caller's plan
// (repro_torch.kernels.bnn_matmul.fwd_plan) from M:
//   - small M (decode M = 4, prefill buckets and chunks of at most 32 rows):
//     stream_matmul.cuh's streaming template (ops SIGN_I8, SIGN_F32), shared
//     with the served CAC: w read once in 16-byte loads, sign mismatches
//     counted four columns a word in byte lanes, K split over warps and a
//     cluster, one launch, no memset, no atomics. Bound by the latency of one
//     pass over the weight bytes (0.75 us of bytes at the gate/up projection).
//   - large M (the training shape, M = 512): the tensor cores. A transposing
//     sign pass writes S[n][k] = sign(w[k][n]) as bf16 +-1 (0 for the pad
//     rows K <= k < KP), K-major, the wgmma B operand; the product template
//     below (mode FWD) forms A = sign(x) in registers from float32 x tiles
//     that TMA brings into shared memory, one bf16 plane and one float32
//     accumulator: every partial sum is an integer of magnitude <= K < 2^24,
//     exact in any order. No mask epilogue. Bound by bytes (x, w and y once:
//     5.09 us at (512, 960, 2560); the 2 M K N products take 2.54 us at the
//     bf16 rate); the popcount form could not reach it (M K N / 32 __popc at
//     16 a clock an SM is 10.6 us there).
//
// Kernel 7 (packed planes): the streaming template's op SIGN_PACKED at
// every M, by the caller's plan (kernels/cac_matmul.stream_plan): each
// 16-byte load of the planes holds 8 K rows of 16 columns, x is staged as
// its positive bit [x >= 0] in bit 7 of each byte lane, and a term is the
// plane bit shifted to bit 7, one LOP3 (the two bits differ exactly where
// the term is -1) and the count. Every 8-row group of a split is one item,
// so a decode split (at most 40 groups) is one chunk; the splits meet in a
// cluster in rank order. One launch, no memset, no atomics, bit for bit
// repeatable. Bound by the latency of one pass over the 1-bit weights
// (0.09 us of bytes at the gate/up projection).
//
// Backward (kernels 8 and 9: one product template, instantiated for dx and
// dw, two tile widths and two load routes; kernel 6's tensor-core route is
// its third mode, FWD, in dx's layout with one plane and no mask). Each is a
// float32 product with +-1 on one side:
//   dx (M, K) = (g @ sign(w)^T) * 1[|x| <= 1], contraction over N;
//   dw (K, N) = (sign(x)^T @ g) * 1[|w| <= 1], computed as its transpose
//     dw^T (N, K) = g^T @ sign(x), contraction over M,
// so that in both g is the wgmma A operand and the +-1 side is B, and the
// output's column axis is K in both.
//
// Arithmetic: bf16 wgmma with float32 accumulation, exact products. The +-1
// side is exact in bf16. g (float32) is split in registers into three bf16
// planes, g1 = bf16_rn(g), g2 = bf16_rn(g - g1), g3 = bf16_rn(g - g1 - g2):
// each residual is exact in float32, g - g1 has at most 17 significant bits
// and g - g1 - g2 at most 8, so g3 takes it whole and g1 + g2 + g3 == g for
// every normal float32 below bf16's overflow point (3.3961776e38; a larger
// |g| or an inf gives inf - inf = NaN in g2). Every (+-1 x g_i) product is
// therefore exact, and the tensor cores compute the same sums as an fmaf
// loop, in another order. Two accumulators: `hi` takes the g1 plane and
// `lo` the g2 and g3 planes, and the result is hi + lo, one float32 add.
// That keeps every term on its accumulator's grid: g1 has 8 significant
// bits, so a g1 term is a multiple of hi's ulp unless |g| is below about
// 2^-16 |hi|, and the lo terms are ~2^-8 of g, summed at ~2^-8 of hi's
// magnitude. However the tensor cores align and round inside an
// accumulation, a sum whose terms all lie on the accumulator's grid is
// exact up to the rounding of its result, so the error is those roundings,
// hi + lo's, and the rare tiny-|g| term.
// (One running sum over all three planes would put the g2 and g3 terms far
// below its ulp: at N = 2560 that is the 1e-4 failure a single float32
// running sum met in the CUDA-core design.)
//
// A call is two kernels. The sign pass writes the +-1 operand as bf16 in
// the layout the product reads, S[k][t] = sign(B[t][k]) with rows padded to
// 8 steps (dx: sign(w), w's own layout; dw: sign(x)^T, through a shared
// tile). The product kernel starts early (programmatic dependent launch):
// its loads of g go out before it waits for the sign pass.
//
// Product tiles: a block owns 128 rows x BN columns of the output (dx: rows
// m, columns k; dw^T: rows n, columns k), BN = 128 or 160 (960 and 2560
// are multiples of 160, and the wider tile halves the waves at the large
// shapes), chosen by the caller's plan. Two consumer warpgroups of 64 rows
// each issue wgmma.m64nBNk16, A (the g planes) from registers and B (the
// +-1 tile) from shared memory. The contraction runs in stages of 64 steps
// through a ring of 4 shared-memory stages: per stage thread 0 issues TMA
// loads (one box of S, two or four of g) onto the stage's mbarrier, all in
// the 128-byte-swizzled layout (rows of 128 bytes, 16-byte chunk j of row i
// at j ^ (i % 8)), which is also the K-major layout the wgmma descriptor
// names for S. Per k16 step a warpgroup waits until one wgmma group is in
// flight, reads its g fragment (float32), splits it and issues three
// wgmmas as one group, so the tensor cores work through one group while
// the next fragment is split (a clock64 profile on the H100 puts a stage
// within a few percent of its wgmmas' own time at the path's shapes).
//
// Grid and determinism: the contraction is split over gridDim.z into 1 to
// 8 ranges of whole stages; the plan (bnn_bwd_launch) weighs waves, stages
// and epilogue. The splits of one tile form a thread block cluster. Each
// block puts its partial tile (hi + lo) in shared memory; after a cluster
// barrier block s sums every s-th group of the tile over the cluster's
// ranks 0, 1, ... in that order (distributed shared memory), applies the
// hard-tanh mask from the output's own operand (x for dx, w for dw, loaded
// by cp.async while E is written) and stores along the output's rows. No
// atomics and no global scratch beyond S: the sum order is fixed, so both
// kernels repeat bit for bit.
//
// Load routes, chosen once per launch: with N and K multiples of 4 and
// 16-byte-aligned operands, TMA (global strides must be 16-byte multiples)
// and float4 epilogue accesses; otherwise every thread copies g 4 bytes at
// a time with cp.async (zero-filled past an edge) into the same swizzled
// layout, S by 16-byte cp.async, and stores are scalar (the ragged shapes
// (129, 968, 65), (37, 100, 130) and (512, 2560, 962)). g is zero past the
// block's contraction range, so whatever the +-1 tile holds there adds
// nothing.
//
// What bounds them on the H100 (NVIDIA data sheet rates): the larger of
// bytes (x, w and g read once, the output written once, at 3.35 TB/s) and
// 3 x 2 M K N bf16 operations at 989 TFLOP/s. At (512, 960, 2560): dx
// 5.67 us by bytes, dw 8.02 us by bytes, 7.63 us of operations; at
// (512, 960, 960) 2.86 / 3.37 us against 2.86 us of operations. The old
// CUDA-core design's fp32 operations bound (2 M K N at 67 TFLOP/s, 37.6 us
// at gate/up) no longer applies.
//
// Ragged M, N and K are masked here (zero-filled loads, guarded stores);
// nothing is padded. No --use_fast_math.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

#include "stream_matmul.cuh"

namespace {

namespace cg = cooperative_groups;

int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---- backward: bf16 wgmma over three planes of g ----

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// until at most PENDING committed wgmma groups of this warpgroup are unfinished
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

// generic-proxy writes to shared memory made visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma window
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// arrive on `bar` and expect `bytes` more of asynchronous copies this phase
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Until the phase of `bar` with this parity has completed. A wait of more
// than 2^33 cycles (seconds) traps, a launch error, instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0)
      start = clock64();
    else if (clock64() - start > (1LL << 33))
      __trap();
  }
}

// TMA: the box of `map` at (c0 inner, c1 outer) into shared memory at dst;
// its bytes count toward `bar`'s expected transaction
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// Shared-memory matrix descriptor of a K-major bf16 tile with 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), the
// leading offset unused for this layout; the tile base is 1024-aligned.
__device__ __forceinline__ uint64_t swizzle128_desc(uint32_t smem_addr) {
  return (uint64_t)((smem_addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d += A B for a 64 x N tile, k = 16 (N = 128 or 160): A bf16 from
// registers (the m16k16 fragment layout of each warp's 16 rows), B bf16
// K-major in shared memory (descriptor), float32 accumulators in the m64nN
// layout
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n160k16(float (&d)[80], const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_bf16(float (&d)[BN / 2], const uint32_t (&a)[4],
                                           uint64_t desc_b) {
  if constexpr (BN == 128)
    wgmma_m64n128k16(d, a, desc_b);
  else
    wgmma_m64n160k16(d, a, desc_b);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

// (a, b) -> its three bf16 planes, each packed as bf16x2 (a low): the sum of
// the planes is (a, b) exactly (see the note above)
__device__ __forceinline__ void split3(float a, float b, uint32_t& p1, uint32_t& p2,
                                       uint32_t& p3) {
  const __nv_bfloat162 h1 = __floats2bfloat162_rn(a, b);
  const float2 f1 = __bfloat1622float2(h1);
  const float ra = a - f1.x, rb = b - f1.y;  // exact
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(ra, rb);
  const float2 f2 = __bfloat1622float2(h2);
  p1 = bf16x2_bits(h1);
  p2 = bf16x2_bits(h2);
  p3 = bf16x2_bits(__floats2bfloat162_rn(ra - f2.x, rb - f2.y));  // exact
}

// +1 or -1 as bf16 bits, from v >= 0 (float32 or int8 v)
template <typename V>
__device__ __forceinline__ uint32_t sign_bf16(V v) { return v >= 0 ? 0x3F80u : 0xBF80u; }

constexpr int BWD_THREADS = 256;   // two consumer warpgroups
constexpr int BWD_BM = 128;        // output rows per block: 64 per warpgroup (wgmma M)
constexpr int BWD_TK = 64;         // contraction steps per stage: one 128-byte bf16 row
constexpr int BWD_STAGES = 4;      // ring depth
constexpr int BWD_MAX_SPLITS = 8;  // the portable cluster size
constexpr int SIGN_TT = 64;        // contraction steps per sign-pass block (dw)
constexpr int SIGN_TC = 32;        // columns per sign-pass block (dw)

// The +-1 operand as bf16, laid out for the product: S[c][t] = sign(B[t][c])
// for t < T (row stride TP = T rounded up to 8, so rows are 16-byte
// aligned; S[c][t] for T <= t < TP is -1, which meets g = 0 there, or with
// ZERO_PAD 0, which meets kernel 6's sign(x) = +1 of a zero-filled x).
//   DX: B[t][c] = w[c, t], T = N: S is w's own layout, 8 values a thread.
//   transposing form, through a shared tile:
//     DW: B[t][c] = x[t, c], T = M: S is x transposed;
//     kernel 6: B[t][c] = w[t, c] (float32 or int8), T = K: S = sign(w)^T.
template <bool DX, bool VEC, typename SRC = float, bool ZERO_PAD = false>
__global__ void __launch_bounds__(256)
bnn_sign_kernel(const SRC* __restrict__ src, uint16_t* __restrict__ s, int K, int T, int TP) {
  // the product kernel may start now: it waits for this grid before it
  // reads s (griddepcontrol.wait), and its own loads of g go ahead
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if constexpr (DX) {
    const long long e = (long long)blockIdx.x * 256 + threadIdx.x;  // (k, 8-step chunk)
    const int chunks = TP / 8;
    if (e >= (long long)K * chunks) return;
    const int c = (int)(e / chunks), t = 8 * (int)(e % chunks);
    const float* row = src + (size_t)c * T;
    uint32_t v[4];
    if (VEC && t + 8 <= T) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(row + t));
      const float4 b = __ldg(reinterpret_cast<const float4*>(row + t + 4));
      v[0] = sign_bf16(a.x) | sign_bf16(a.y) << 16;
      v[1] = sign_bf16(a.z) | sign_bf16(a.w) << 16;
      v[2] = sign_bf16(b.x) | sign_bf16(b.y) << 16;
      v[3] = sign_bf16(b.z) | sign_bf16(b.w) << 16;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = (t + 2 * i < T ? sign_bf16(row[t + 2 * i]) : 0xBF80u) |
               (t + 2 * i + 1 < T ? sign_bf16(row[t + 2 * i + 1]) : 0xBF80u) << 16;
    }
    *reinterpret_cast<uint4*>(s + (size_t)c * TP + t) = make_uint4(v[0], v[1], v[2], v[3]);
  } else {
    __shared__ __align__(16) uint16_t tile[SIGN_TC][SIGN_TT + 8];
    const int c0 = blockIdx.x * SIGN_TC, t0 = blockIdx.y * SIGN_TT;
#pragma unroll
    for (int i = 0; i < SIGN_TT * SIGN_TC / 256; ++i) {
      const int e = threadIdx.x + 256 * i;
      const int t = e / SIGN_TC, c = e % SIGN_TC;  // neighbouring threads on c: src rows
      const bool in = t0 + t < T && c0 + c < K;
      tile[c][t] = in ? (uint16_t)sign_bf16(src[(size_t)(t0 + t) * K + c0 + c])
                      : (ZERO_PAD ? 0 : 0xBF80);
    }
    __syncthreads();
    const int c = threadIdx.x / (SIGN_TT / 8), j = threadIdx.x % (SIGN_TT / 8);
    if (c0 + c < K && t0 + 8 * j < TP)
      *reinterpret_cast<uint4*>(s + (size_t)(c0 + c) * TP + t0 + 8 * j) =
          *reinterpret_cast<const uint4*>(&tile[c][8 * j]);
  }
}

// Shared-memory layout, in bytes from a 1024-aligned base: a ring of
// stages, each the +-1 tile Bt (BN rows x TK bf16) and then the float32 g
// tile, both in the 128-byte-swizzled layout TMA writes: rows of 128 bytes,
// 16-byte chunk j of row i at chunk j ^ (i % 8).
//   dx: g as two [128 rows m][32 n] halves (n 0-31, 32-63)
//   dw: g as four [64 rows m][32 n] quarters (n 0-31, ..., 96-127)
// Then one mbarrier per stage. The epilogue's partial tile E and the mask
// operand's tile reuse the ring:
//   E: dx [BM][BN + 8] (row r = m); dw [BN][BM + 4] (row c = k)
// (the paddings make the E writes conflict-free).
template <bool DX, int BN>
struct BwdSmem {
  static constexpr int BT_BYTES = BN * BWD_TK * 2;
  static constexpr int G_BYTES = BWD_BM * BWD_TK * 4;
  static constexpr int STAGE_BYTES = BT_BYTES + G_BYTES;
  static constexpr int RING_BYTES = BWD_STAGES * STAGE_BYTES;
  static constexpr int E_LD = DX ? BN + 8 : BWD_BM + 4;
  static constexpr int E_BYTES = (DX ? BWD_BM : BN) * E_LD * 4;
  static constexpr int MASK_BYTES = BWD_BM * BN * 4;
  static constexpr int BYTES = 1024 + RING_BYTES + 8 * BWD_STAGES;
  static_assert(STAGE_BYTES % 1024 == 0, "every tile 1024-aligned");
  static_assert(E_BYTES % 16 == 0 && E_BYTES + MASK_BYTES <= RING_BYTES, "E and mask fit");
  static_assert(BYTES <= 232448, "H100 shared memory per block");
};

// byte offset of g element (i, j) in a stage's g tile: DX (row m = i, step
// n = j); DW (step m = i, row n = j)
template <bool DX>
__device__ __forceinline__ int g_offset(int i, int j) {
  constexpr int PART = DX ? BWD_BM * 128 : BWD_TK * 128;  // one 32-column part
  return (j >> 5) * PART + i * 128 + ((((j & 31) >> 2) ^ (i & 7)) << 4) + ((j & 3) << 2);
}

// The product modes: kernels 9 (dw), 8 (dx) and 6 at large M (fwd).
enum ProductMode { P_DW = 0, P_DX = 1, P_FWD = 2 };

// out[r][c] = mask(r, c) * sum_t A[r][t] * B[t][c] over a 128 x BN tile:
//   DX: out = dx (M, K): r = m, c = k, t = n; A = g[m, n], B = sign(w[k, n]),
//       mask = 1[|x[m, k]| <= 1]
//   DW: out = dw^T (N, K), stored as dw (K, N): r = n, c = k, t = m;
//       A = g[m, n], B = sign(x[m, k]), mask = 1[|w[k, n]| <= 1]
//   FWD (kernel 6, in DX's layout, called with N := kernel 6's K and K :=
//       its N): out = y: r = m, c = n, t = k; A = sign(x[m, k]) formed in
//       registers from the float32 x tile (the `g` operand), one bf16 plane
//       and the hi accumulator only, B = sign(w[k, n]), no mask.
// B comes as bnn_sign_kernel's S (row stride TP). The block's contraction
// range is split s = its cluster rank, of gridDim.z. VEC (N % 4 == 0, K %
// 4 == 0, 16-byte-aligned operands): thread 0 loads each stage with TMA
// (g_map, s_map) onto the stage's mbarrier. Otherwise every thread copies
// with cp.async (4 bytes of g, 16 of S) into the same layout.
template <int MODE, bool VEC, int BN>
__global__ void __launch_bounds__(BWD_THREADS, 1)
bnn_bwd_kernel(const __grid_constant__ CUtensorMap g_map,
               const __grid_constant__ CUtensorMap s_map, const float* __restrict__ x,
               const float* __restrict__ w, const float* __restrict__ g,
               const uint16_t* __restrict__ sgn, float* __restrict__ out, int M, int N, int K,
               int TP, int t_per_split) {
  constexpr bool DX = MODE != P_DW, FWD = MODE == P_FWD;
  using L = BwdSmem<DX, BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = (uint32_t)__cvta_generic_to_shared(smem_raw);
  uint8_t* ring = smem_raw + ((1024 - (raw_addr & 1023)) & 1023);
  const uint32_t ring_addr = (uint32_t)__cvta_generic_to_shared(ring);
  const uint32_t bar_addr = ring_addr + L::RING_BYTES;  // mbarrier of stage slot i at + 8 i

  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.block_rank(), nsplit = (int)cluster.num_blocks();
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gid = lane / 4, tig = lane % 4;
  const int row_a = 64 * (warp / 4) + 16 * (warp % 4) + gid;  // this thread's rows: +0, +8
  const int T = DX ? N : M;
  const int r0 = blockIdx.y * BWD_BM, c0 = blockIdx.x * BN;
  const int t_begin = split * t_per_split;
  const int t_end = min(T, t_begin + t_per_split);
  const int stages = t_end > t_begin ? (t_end - t_begin + BWD_TK - 1) / BWD_TK : 0;

  if (VEC && tid == 0) {
#pragma unroll
    for (int i = 0; i < BWD_STAGES; ++i) mbar_init(bar_addr + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Stage s into slot s % STAGES. VEC: thread 0, two (dx) or four (dw) TMA
  // boxes of g and one of S; past an edge TMA fills zeros, and a split's
  // range is whole stages, so no box reaches into the next range. Else: 32
  // 4-byte copies of g and 4 16-byte copies of S per thread, zero-filled
  // past t_end and the edges. The g part may run before the sign pass has
  // finished; the S part only after griddepcontrol.wait.
  auto load_g = [&](int s) {
    const int slot = s % BWD_STAGES;
    const int t0 = t_begin + s * BWD_TK;
    if constexpr (VEC) {
      if (tid != 0) return;
      const uint32_t bar = bar_addr + 8 * slot;
      const uint32_t gt = ring_addr + slot * L::STAGE_BYTES + L::BT_BYTES;
      fence_proxy_async();  // the slot's earlier shared-memory reads come first
      mbar_expect(bar, L::STAGE_BYTES);  // the g boxes and the S box
      if constexpr (DX) {
        tma_load_2d(gt, &g_map, t0, r0, bar);
        tma_load_2d(gt + BWD_BM * 128, &g_map, t0 + 32, r0, bar);
      } else {
#pragma unroll
        for (int j = 0; j < BWD_BM / 32; ++j)
          tma_load_2d(gt + j * BWD_TK * 128, &g_map, r0 + 32 * j, t0, bar);
      }
    } else {
      uint8_t* gs = ring + slot * L::STAGE_BYTES + L::BT_BYTES;
#pragma unroll 8
      for (int e = tid; e < BWD_BM * BWD_TK; e += BWD_THREADS) {
        const int i = e / (DX ? BWD_TK : BWD_BM), j = e % (DX ? BWD_TK : BWD_BM);
        const int m = DX ? r0 + i : t0 + i, n = DX ? t0 + j : r0 + j;
        const bool ok = m < M && n < N && (DX ? n : m) < t_end;
        cp_async4(gs + g_offset<DX>(i, j), ok ? g + (size_t)m * N + n : g, ok ? 4 : 0);
      }
    }
  };
  auto load_s = [&](int s) {
    const int slot = s % BWD_STAGES;
    const int t0 = t_begin + s * BWD_TK;
    if constexpr (VEC) {
      if (tid == 0)
        tma_load_2d(ring_addr + slot * L::STAGE_BYTES, &s_map, t0, c0, bar_addr + 8 * slot);
    } else {
#pragma unroll
      for (int e = tid; e < BN * (BWD_TK / 8); e += BWD_THREADS) {
        const int c = e / (BWD_TK / 8), j = e % (BWD_TK / 8);
        const bool ok = c0 + c < K && t0 + 8 * j < TP;
        cp_async16(ring + slot * L::STAGE_BYTES + c * 128 + ((j ^ (c % 8)) << 4),
                   ok ? sgn + (size_t)(c0 + c) * TP + t0 + 8 * j : sgn, ok ? 16 : 0);
      }
    }
  };

  float hi[BN / 2], lo[FWD ? 1 : BN / 2];  // FWD: hi only
  uint32_t a[2][3][4];  // two steps' A fragments: [plane][register]
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) hi[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (FWD ? 1 : BN / 2); ++i) lo[i] = 0.f;
  fence_operands(hi);
  if (!FWD) fence_operands(lo);

#pragma unroll
  for (int s = 0; s < BWD_STAGES - 1; ++s)
    if (s < stages) load_g(s);
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the sign pass is done
#pragma unroll
  for (int s = 0; s < BWD_STAGES - 1; ++s) {
    if (s < stages) load_s(s);
    if (!VEC) cp_async_commit();
  }
  for (int s = 0; s < stages; ++s) {
    const int slot = s % BWD_STAGES;
    if constexpr (VEC) {
      mbar_wait(bar_addr + 8 * slot, (s / BWD_STAGES) & 1);  // stage s has landed
    } else {
      cp_async_wait<BWD_STAGES - 2>();  // this thread's copies of stage s have landed
      fence_proxy_async();              // ... and are visible to wgmma
      __syncthreads();                  // everyone's are
    }
    const uint8_t* gs = ring + slot * L::STAGE_BYTES + L::BT_BYTES;
    const uint32_t bt_addr = ring_addr + slot * L::STAGE_BYTES;

    // Per k16 step: wait until at most one group is unfinished (the group
    // two steps back, the last reader of a[kk % 2], is done), load this
    // thread's A fragment (rows row_a and row_a + 8; steps 2 tig, +1 and
    // 2 tig + 8, +9), split it into the three planes and issue the step's
    // three wgmmas as one group. The tensor cores work through the previous
    // group while the next fragment is split.
#pragma unroll
    for (int kk = 0; kk < BWD_TK / 16; ++kk) {
      wgmma_wait<1>();
      uint32_t (&ak)[3][4] = a[kk % 2];
      float2 p[4];
      const int t = 16 * kk + 2 * tig;
      if constexpr (DX) {
        p[0] = *reinterpret_cast<const float2*>(gs + g_offset<DX>(row_a, t));
        p[1] = *reinterpret_cast<const float2*>(gs + g_offset<DX>(row_a + 8, t));
        p[2] = *reinterpret_cast<const float2*>(gs + g_offset<DX>(row_a, t + 8));
        p[3] = *reinterpret_cast<const float2*>(gs + g_offset<DX>(row_a + 8, t + 8));
      } else {
        const auto at = [&](int tt, int r) {
          return *reinterpret_cast<const float*>(gs + g_offset<DX>(tt, r));
        };
        p[0] = make_float2(at(t, row_a), at(t + 1, row_a));
        p[1] = make_float2(at(t, row_a + 8), at(t + 1, row_a + 8));
        p[2] = make_float2(at(t + 8, row_a), at(t + 9, row_a));
        p[3] = make_float2(at(t + 8, row_a + 8), at(t + 9, row_a + 8));
      }
      if constexpr (FWD) {
#pragma unroll
        for (int j = 0; j < 4; ++j) ak[0][j] = sign_bf16(p[j].x) | sign_bf16(p[j].y) << 16;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) split3(p[j].x, p[j].y, ak[0][j], ak[1][j], ak[2][j]);
      }
      wgmma_fence();
      const uint64_t desc = swizzle128_desc(bt_addr + 32 * kk);  // 16 bf16 further along t
      wgmma_bf16<BN>(hi, ak[0], desc);
      if constexpr (!FWD) {
        wgmma_bf16<BN>(lo, ak[1], desc);
        wgmma_bf16<BN>(lo, ak[2], desc);
      }
      wgmma_commit();
    }
    // every group of stage s - 1 has completed in this warpgroup (the wait
    // at kk = 1); once both warpgroups are here its slot takes stage s + 3
    __syncthreads();
    if (s + BWD_STAGES - 1 < stages) {
      load_g(s + BWD_STAGES - 1);
      load_s(s + BWD_STAGES - 1);
    }
    if (!VEC) cp_async_commit();
  }
  wgmma_wait<0>();
  fence_operands(hi);
  if (!FWD) fence_operands(lo);
  const int rows = DX ? M : K, cols = DX ? K : N;
  const float* own = DX ? x : w;

  if (!VEC) cp_async_wait<0>();
  __syncthreads();  // the ring is free: E and the mask tile take its place

  // Block s of the cluster finishes every s-th group of 256 float4 of the
  // tile (at most 20 per thread): the partials summed over ranks 0, 1, ...
  // in order, masked and stored along the output's contiguous axis (dx: k;
  // dw: n). This thread's mask operand values (x for dx, w for dw) come in
  // first by cp.async, so that their latency overlaps writing E and the
  // cluster barrier; each thread reads back only its own copies.
  constexpr int LINE4 = (DX ? BN : BWD_BM) / 4;  // float4 per E line
  constexpr int CHUNKS = BWD_BM * BN / 4;         // float4 in the tile
  constexpr int MAX_Q = CHUNKS / BWD_THREADS;          // per thread, one split
  constexpr bool FIXED_COL = BWD_THREADS % LINE4 == 0;  // a thread's col0 never changes
  float* E = reinterpret_cast<float*>(ring);
  float4* mask = reinterpret_cast<float4*>(ring + L::E_BYTES) + tid;  // + i * BWD_THREADS
#pragma unroll
  for (int i = 0; i < MAX_Q; ++i) {
    const int q = (split + nsplit * i) * BWD_THREADS + tid;
    const int line = q / LINE4;
    const int row = (DX ? r0 : c0) + line, col0 = (DX ? c0 : r0) + 4 * (q % LINE4);
    if (q >= CHUNKS || row >= rows) break;  // q and row grow with i
    if (col0 >= cols) {
      if (FIXED_COL) break;
      continue;
    }
    if constexpr (FWD) break;  // no mask
    const float* o = own + (size_t)row * cols + col0;
    if constexpr (VEC) {
      cp_async16(mask + i * BWD_THREADS, o, 16);
    } else {
      float* d = reinterpret_cast<float*>(mask + i * BWD_THREADS);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = col0 + e < cols;
        cp_async4(d + e, ok ? o + e : own, ok ? 4 : 0);
      }
    }
  }
  cp_async_commit();

  // this block's partial tile, hi + lo (FWD: hi), into E (accumulator
  // element 4j + e sits at row row_a + 8 (e / 2), column 8 j + 2 tig + e % 2)
  const auto part = [&](int i) { return FWD ? hi[i] : hi[i] + lo[FWD ? 0 : i]; };
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * tig;
    const float v0 = part(4 * j), v1 = part(4 * j + 1);
    const float v2 = part(4 * j + 2), v3 = part(4 * j + 3);
    if constexpr (DX) {
      *reinterpret_cast<float2*>(E + row_a * L::E_LD + col) = make_float2(v0, v1);
      *reinterpret_cast<float2*>(E + (row_a + 8) * L::E_LD + col) = make_float2(v2, v3);
    } else {
      E[col * L::E_LD + row_a] = v0;
      E[(col + 1) * L::E_LD + row_a] = v1;
      E[col * L::E_LD + row_a + 8] = v2;
      E[(col + 1) * L::E_LD + row_a + 8] = v3;
    }
  }
  cp_async_wait<0>();
  if (nsplit > 1)
    cluster.sync();  // every split's partial tile is in place
  else
    __syncthreads();

#pragma unroll
  for (int i = 0; i < MAX_Q; ++i) {
    const int q = (split + nsplit * i) * BWD_THREADS + tid;
    const int line = q / LINE4;
    const int row = (DX ? r0 : c0) + line, col0 = (DX ? c0 : r0) + 4 * (q % LINE4);
    if (q >= CHUNKS || row >= rows) break;
    if (col0 >= cols) {
      if (FIXED_COL) break;
      continue;
    }
    const int off = line * L::E_LD + 4 * (q % LINE4);
    float4 v = *reinterpret_cast<const float4*>(cluster.map_shared_rank(E, 0) + off);
    for (int r = 1; r < nsplit; ++r) {
      const float4 u = *reinterpret_cast<const float4*>(cluster.map_shared_rank(E, r) + off);
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    // the mask from the operand's own value (NaN fails it); where it is 0
    // the result is +0, as the plain version's select gives
    if constexpr (!FWD) {
      const float4 m = mask[i * BWD_THREADS];
      v = make_float4(fabsf(m.x) <= 1.f ? v.x : 0.f, fabsf(m.y) <= 1.f ? v.y : 0.f,
                      fabsf(m.z) <= 1.f ? v.z : 0.f, fabsf(m.w) <= 1.f ? v.w : 0.f);
    }
    float* o = out + (size_t)row * cols + col0;
    if (VEC) {  // cols % 4 == 0: the whole float4 is inside
      *reinterpret_cast<float4*>(o) = v;
    } else {
      if (col0 < cols) o[0] = v.x;
      if (col0 + 1 < cols) o[1] = v.y;
      if (col0 + 2 < cols) o[2] = v.z;
      if (col0 + 3 < cols) o[3] = v.w;
    }
  }
  if (nsplit > 1) cluster.sync();  // no block leaves while another still reads its E
}

// cuTensorMapEncodeTiled, from the driver through the runtime (so the
// library needs no -lcuda), or null
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A TMA map of a row-major (rows, cols) matrix with row stride ld elements
// of `elem` bytes, boxes of box_rows x box_cols, 128-byte swizzle, zeros
// past the edges. False if the driver refuses it.
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* base,
                int rows, int cols, int ld, int box_rows, int box_cols) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * elem};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t one[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, one,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The launch configuration of the product in mode MODE with `splits` blocks
// a cluster (grid x: column tiles, y: row tiles, z: splits).
template <int MODE, bool VEC, int BN>
cudaError_t bwd_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute (&attr)[2], int M, int N,
                       int K, int splits) {
  constexpr bool DX = MODE != P_DW;
  constexpr int bytes = BwdSmem<DX, BN>::BYTES;
  static uint64_t configured = 0;  // a bit per device: the attribute is set there
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev >= 64 || !(configured >> dev & 1))) {
    err = cudaFuncSetAttribute(bnn_bwd_kernel<MODE, VEC, BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess && dev < 64) configured |= (uint64_t)1 << dev;
  }
  cfg = {};
  cfg.gridDim = dim3(cdiv(K, BN), cdiv(DX ? M : N, BWD_BM), splits);
  cfg.blockDim = dim3(BWD_THREADS);
  cfg.dynamicSmemBytes = bytes;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  // may start while the sign pass (the stream's previous kernel) finishes
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return err;
}

// The sign pass, then the product, in the product's convention: the
// contraction T = N (DX, FWD) or M (DW), output columns K. For FWD, g is
// kernel 6's x (M, N := its K), `src` its w (N rows := its K, K columns :=
// its N), and x and w (the mask operands) are unused.
template <int MODE, bool VEC, int BN, typename SRC = float>
cudaError_t launch_bwd(const float* x, const float* w, const SRC* src, const float* g,
                       uint16_t* sgn, float* out, int M, int N, int K, int splits,
                       int t_per_split, cudaStream_t st) {
  constexpr bool DX = MODE != P_DW;
  const int T = DX ? N : M, TP = cdiv(T, 8) * 8;
  const dim3 transposing(cdiv(K, SIGN_TC), cdiv(TP, SIGN_TT));
  if constexpr (MODE == P_DX)
    bnn_sign_kernel<true, VEC><<<(unsigned)cdiv(K * (TP / 8), 256), 256, 0, st>>>(src, sgn, K,
                                                                                   T, TP);
  else if constexpr (MODE == P_DW)  // (the transpose reads x a float at a time either way)
    bnn_sign_kernel<false, false><<<transposing, 256, 0, st>>>(src, sgn, K, T, TP);
  else
    bnn_sign_kernel<false, false, SRC, true><<<transposing, 256, 0, st>>>(src, sgn, K, T, TP);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap g_map = {}, s_map = {};  // unused by the 4-byte route
  if (VEC && !(tensor_map(&g_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, g, M, N, N,
                          DX ? BWD_BM : BWD_TK, 32) &&
               tensor_map(&s_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, sgn, K, TP, TP, BN,
                          BWD_TK)))
    return cudaErrorNotSupported;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  err = bwd_config<MODE, VEC, BN>(cfg, attr, M, N, K, splits);
  if (err != cudaSuccess) return err;
  cfg.stream = st;
  return cudaLaunchKernelEx(&cfg, bnn_bwd_kernel<MODE, VEC, BN>, g_map, s_map, x, w, g,
                            static_cast<const uint16_t*>(sgn), out, M, N, K, TP, t_per_split);
}

// How many blocks of the product in mode MODE with `bn`-column tiles can be
// resident at once when `splits` blocks form a cluster (each block takes a
// whole SM): the card's cluster occupancy times splits, or -1 if it cannot
// say.
template <int MODE, int BN>
int max_blocks(int splits) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  int clusters = 0;
  cudaError_t err = bwd_config<MODE, true, BN>(cfg, attr, BWD_BM, BWD_BM, BN, splits);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&clusters, bnn_bwd_kernel<MODE, true, BN>, &cfg);
  return err == cudaSuccess ? clusters * splits : -1;
}

bool plan_ok(int T, int bn, int splits, int t_per_split) {
  return (bn == 128 || bn == 160) && splits >= 1 && splits <= BWD_MAX_SPLITS &&
         t_per_split > 0 && t_per_split % BWD_TK == 0 && (long long)splits * t_per_split >= T &&
         (long long)(splits - 1) * t_per_split < T;
}

}  // namespace

// Kernel 7 (stream_matmul.cuh, op SIGN_PACKED). x float32 (M, K), wp uint8
// bitplanes (K/8, N), K % 8 == 0 -> y float32 (M, N), exact integer sums, by
// the caller's plan (repro_torch.kernels.cac_matmul.stream_plan): `mt` rows
// a tile, `splits` blocks a cluster, `groups_per_split` 8-row groups each.
// One launch; writes every element of y; does not synchronise; returns the
// launch's error or cudaErrorInvalidValue.
extern "C" int bnn_packed_launch(const void* x, const void* wp, void* y, int M, int N, int K,
                                 int mt, int splits, int groups_per_split, void* stream) {
  if (K % 8) return (int)cudaErrorInvalidValue;
  const cudaError_t err = stream::launch<stream::SIGN_PACKED>(
      x, nullptr, static_cast<const uint8_t*>(wp), static_cast<float*>(y), M, N, K, mt, splits,
      groups_per_split, static_cast<cudaStream_t>(stream));
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// Resident blocks of kernel 7 with `mt`-row tiles in clusters of `splits`;
// -1 if the card cannot say.
extern "C" int packed_max_blocks(int mt, int splits) {
  return stream::max_blocks<stream::SIGN_PACKED>(mt, splits);
}

// Kernel 6, small-M route (stream_matmul.cuh). x float32 (M, K); w float32
// (w_kind 0) or int8 (w_kind 1) (K, N) -> y float32 (M, N), exact integer
// sums, by the caller's plan (repro_torch.kernels.cac_matmul.stream_plan):
// `mt` rows a tile, `splits` blocks a cluster, `groups_per_split` 8-row
// groups each. One launch; writes every element of y; does not
// synchronise; returns the launch's error or cudaErrorInvalidValue.
extern "C" int bnn_fwd_stream_launch(const void* x, const void* w, void* y, int M, int N, int K,
                                     int w_kind, int mt, int splits, int groups_per_split,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* yf = static_cast<float*>(y);
  cudaError_t err;
  if (w_kind == 0)
    err = stream::launch<stream::SIGN_F32>(x, w, nullptr, yf, M, N, K, mt, splits,
                                           groups_per_split, st);
  else if (w_kind == 1)
    err = stream::launch<stream::SIGN_I8>(x, w, nullptr, yf, M, N, K, mt, splits,
                                          groups_per_split, st);
  else
    err = cudaErrorInvalidValue;
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// Resident blocks of kernel 6's small-M route with `mt`-row tiles in
// clusters of `splits` (its two weight kinds take the same registers and
// shared memory); -1 if the card cannot say.
extern "C" int stream_max_blocks(int mt, int splits) {
  return stream::max_blocks<stream::SIGN_I8>(mt, splits);
}

// Kernel 6, tensor-core route. x float32 (M, K); w float32 (w_kind 0) or
// int8 (w_kind 1) (K, N) -> y float32 (M, N), exact integer sums. `sgn` is
// scratch of N * KP bf16 (KP = K rounded up to 8) for S = sign(w)^T, written
// here first. Output tiles are 128 rows x `bn` columns (n); the contraction
// K is cut into `splits` ranges of `k_per_split` (a multiple of 64) by the
// caller's plan (repro_torch.kernels.bnn_matmul.fwd_plan). Two kernels (the
// sign pass, then the product), writes every element of y, does not
// synchronise, returns the first launch error or cudaErrorInvalidValue.
extern "C" int bnn_fwd_tc_launch(const void* x, const void* w, void* y, void* sgn, int M, int N,
                                 int K, int w_kind, int bn, int splits, int k_per_split,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || K >= (1 << 24) || (w_kind != 0 && w_kind != 1) ||
      !plan_ok(K, bn, splits, k_per_split) || (long long)N * (cdiv(K, 8) * 8) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  uint16_t* sf = static_cast<uint16_t*>(sgn);
  float* yf = static_cast<float*>(y);
  // TMA wants x's row stride a multiple of 16 bytes; the float4 stores N % 4
  const bool vec = N % 4 == 0 && K % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16) == 0;
  const int route = (w_kind == 1 ? 4 : 0) | (vec ? 2 : 0) | (bn == 160 ? 1 : 0);
  cudaError_t err;
  switch (route) {
#define BNN_FWD_ROUTE(R, SRC, VEC, BN)                                                        \
  case R:                                                                                     \
    err = launch_bwd<P_FWD, VEC, BN, SRC>(nullptr, nullptr, static_cast<const SRC*>(w), xf, \
                                          sf, yf, M, K, N, splits, k_per_split, st);          \
    break;
    BNN_FWD_ROUTE(0, float, false, 128)
    BNN_FWD_ROUTE(1, float, false, 160)
    BNN_FWD_ROUTE(2, float, true, 128)
    BNN_FWD_ROUTE(3, float, true, 160)
    BNN_FWD_ROUTE(4, int8_t, false, 128)
    BNN_FWD_ROUTE(5, int8_t, false, 160)
    BNN_FWD_ROUTE(6, int8_t, true, 128)
    default:
      BNN_FWD_ROUTE(7, int8_t, true, 160)
#undef BNN_FWD_ROUTE
  }
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// Kernels 8 (want_dx != 0: out = dx (M, K)) and 9 (want_dx == 0: out = dw
// (K, N)). x (M, K), w (K, N), g (M, N), all float32; `sgn` is scratch of
// K * TP bf16 (TP = T rounded up to 8; T = N for dx, M for dw) for the +-1
// operand, written here first. Output tiles are 128 rows x `bn` columns
// (bn = 128 or 160; the columns are K's). The contraction T is cut into
// `splits` ranges of `t_per_split` steps, split s taking [s t_per_split,
// (s + 1) t_per_split): 1 <= splits <= 8 (one cluster per output tile),
// t_per_split a multiple of 64, and the ranges cover T with none empty.
// The caller's plan (repro_torch.kernels.bnn_matmul.bwd_plan) picks them
// to fill the card. Writes every element of `out`, launches on `stream`
// (two kernels: the +-1 operand, then the product), does not synchronise,
// returns the first launch error or cudaErrorInvalidValue for a plan or
// shape it does not take.
extern "C" int bnn_bwd_launch(const void* x, const void* w, const void* g, void* out,
                              void* sgn, int M, int N, int K, int want_dx, int bn, int splits,
                              int t_per_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int T = want_dx ? N : M;
  if (M <= 0 || N <= 0 || K <= 0 || !plan_ok(T, bn, splits, t_per_split) ||
      (long long)K * (cdiv(T, 8) * 8) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* gf = static_cast<const float*>(g);
  uint16_t* sf = static_cast<uint16_t*>(sgn);
  float* of = static_cast<float*>(out);
  const bool vec = N % 4 == 0 && K % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                     reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  const int route = (want_dx ? 4 : 0) | (vec ? 2 : 0) | (bn == 160 ? 1 : 0);
  cudaError_t err;
  switch (route) {
#define BNN_BWD_ROUTE(R, MODE, VEC, BN)                                                     \
  case R:                                                                                   \
    err = launch_bwd<MODE, VEC, BN>(xf, wf, MODE == P_DX ? wf : xf, gf, sf, of, M, N, K,    \
                                    splits, t_per_split, st);                               \
    break;
    BNN_BWD_ROUTE(0, P_DW, false, 128)
    BNN_BWD_ROUTE(1, P_DW, false, 160)
    BNN_BWD_ROUTE(2, P_DW, true, 128)
    BNN_BWD_ROUTE(3, P_DW, true, 160)
    BNN_BWD_ROUTE(4, P_DX, false, 128)
    BNN_BWD_ROUTE(5, P_DX, false, 160)
    BNN_BWD_ROUTE(6, P_DX, true, 128)
    default:
      BNN_BWD_ROUTE(7, P_DX, true, 160)
#undef BNN_BWD_ROUTE
  }
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// Resident blocks of the product in `mode` (0: kernel 9, dw; 1: kernel 8,
// dx; 2: kernel 6's tensor-core route) with `bn`-column tiles in clusters of
// `splits`; -1 if the card cannot say or the arguments are out of range.
extern "C" int bnn_bwd_max_blocks(int mode, int bn, int splits) {
  if (splits < 1 || splits > BWD_MAX_SPLITS || (bn != 128 && bn != 160)) return -1;
  if (mode == P_DW)
    return bn == 128 ? max_blocks<P_DW, 128>(splits) : max_blocks<P_DW, 160>(splits);
  if (mode == P_DX)
    return bn == 128 ? max_blocks<P_DX, 128>(splits) : max_blocks<P_DX, 160>(splits);
  if (mode == P_FWD)
    return bn == 128 ? max_blocks<P_FWD, 128>(splits) : max_blocks<P_FWD, 160>(splits);
  return -1;
}
