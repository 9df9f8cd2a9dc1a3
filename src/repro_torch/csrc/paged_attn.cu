// Fused paged attention for Hopper (sm_90a): each row's block table split
// over a thread block cluster, the softmax partials merged in rank order.
// Paged decode (C = 1), the speculative verify (C = k) and chunked prefill
// (C = chunk) use the same kernel.
//
// Replaces: src/repro/kernels/paged_attn.py :: paged_attn_kernel_call
//           (Pallas body _paged_attn_kernel).
//
// Computes, per row b, query token c and query head hq (kv head hq / G):
//   score[t] = dot(q[b,c,hq], K[t]) / sqrt(D), masked to -1e30 unless
//              kv_pos t <= q_pos[b,c]
//   out      = softmax(score) @ V, in float32
// where K/V position t of row b lives at pool[tables[b, t / bs], t % bs].
// With int8 pools K/V are dequantized as float(k) * scale[block, position,
// head] as they are staged. Accurate expf (no fast math).
//
// What bounds it on the H100: at the serve shapes neither the bytes (a
// decode call reads well under 1 MB of live K/V, under 0.3 us at 3.35
// TB/s) nor the operations (about 4 D per (query, position) pair, on the
// CUDA cores: the float32 tolerance of 2e-5 rules out TF32 and bf16
// operands) but the latency of one chain: read the positions and the table,
// read K/V, score, merge. At long contexts (T = 64) the K/V bytes weigh in.
//
// Design. Grid (B, Hkv, q_tiles * S), a cluster of S blocks along z. The
// plan (attn_plan below): S = min(T, 8), the portable cluster size, or
// min(T, 16) past T = 8 where that grid is one wave of the card; one query
// token a tile where that grid is one wave, else up to 8.
// - Rank r takes table blocks r, r + S, r + 2S, ... up to the tile's last
//   live block (the whole-block skip past the tile's max q_pos), so the
//   live blocks spread over the ranks whatever the context. A rank whose
//   blocks all lie past it reads the positions and its table entries and
//   nothing else.
// - A rank reads the tile's positions and its table entries at once, then
//   issues every K/V load of its first block (16-byte loads, adjacent
//   threads on adjacent addresses) before it stages q, and holds the next
//   block's loads in registers while it computes this one (T > S).
// - One warp a query vector (the tile's tokens times the GQA group, spread
//   over up to 8 warps; a block has as many warps as query vectors, up to
//   8). Scores: TW positions a pass over the warp, L = 32 / TW lanes a
//   position (two at bs = 16) splitting D and meeting by shuffle. p @ V:
//   p goes through the warp's row of shared memory and each lane owns D /
//   32 output dims. A query vector's running (m, l, acc) stay in its warp's
//   registers. With one warp a query vector every step is a chain of
//   dependent instructions, so the serve shapes (bs = 16, D = 32 DI) have
//   their own instantiation whose loops all have known trip counts.
// - p is 0 at a masked position, so a query that sees no unmasked position
//   in a rank keeps l = 0 and acc = 0 there (never exp(-1e30 + 1e30) = 1).
// - Ranks 1.. store (m, l, acc) into rank 0's slots through distributed
//   shared memory with st.async, whose bytes complete a transaction count
//   on an mbarrier in rank 0 (no memory fence on the way: a release cluster
//   barrier compiles to a GPU-wide one), and leave. Rank 0 waits for the bytes and merges in
//   rank order: m* = max m_r, a_r = exp(m_r - m*) (one lane a rank), l =
//   sum a_r l_r, acc = sum a_r acc_r, out = acc / l. Rank 0 holds block 0,
//   whose position 0 every query sees, so m* is real. One launch, no
//   memset, no atomics, no workspace; the order is fixed, so a call repeats
//   bit for bit.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "stream_matmul.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int PA_MAX_WARPS = 8;
constexpr int PA_SPLITS = 8;       // the portable cluster size
constexpr int PA_MAX_SPLITS = 16;  // a non-portable cluster: T > 8, where the grid stays one wave
constexpr int PA_QTILE = 8;        // query tokens a tile, at most
constexpr int PA_MAX_QTILE = 32;   // a warp reduces the tile's positions
constexpr int PA_RU = 4;           // 16-byte K (and V) loads a thread holds in flight
constexpr int PA_PMAX = 4;         // position passes a lane scores: bs <= 128
constexpr int PA_MAX_D = 256;      // D <= 32 lanes x 8 dims
constexpr int PA_MAX_BS = 32 * PA_PMAX;
constexpr int PA_SMS = 132;                     // the H100's SMs: the plan's one wave
constexpr size_t PA_SMEM_BUDGET = 110 * 1024;  // two blocks an SM
constexpr size_t PA_SMEM_MAX = 232448;          // a block's most (227 KB)
constexpr float PA_NEG_INF = -1e30f;            // the reference's mask value
constexpr unsigned FULL = 0xffffffffu;

// output dims a lane owns: the least power of two DI with 32 DI >= D
__host__ __device__ constexpr int dims_per_lane(int D) {
  return D <= 32 ? 1 : D <= 64 ? 2 : D <= 128 ? 4 : 8;
}

// query vectors a warp holds, each with DI + 2 registers of state
__host__ __device__ constexpr int qmax_for(int di) { return di <= 2 ? 4 : (di == 4 ? 2 : 1); }

// Shared memory of one block, byte offsets: rank 0's mbarrier, q (QV rows
// of DP floats), K (bs rows of KP: a row 32 bytes past a multiple of 128,
// so the two lanes of a position and the four positions of a quarter-warp
// hit distinct banks), V (bs rows of DP), each warp's p row (bs floats),
// rank 0's slots for ranks 1..S-1 ((m, l) and acc of each query vector),
// the tile's positions and the rank's table entries. The same formula is
// repro_torch.kernels.paged_attn.attn_smem_bytes.
struct Layout {
  int DP, KP, QV, nt;
  size_t bar, qs, kb, vb, pw, ml, acc, qp, tb, bytes;
  __host__ __device__ Layout(int q_tile, int G, int D, int bs, int T, int S) {
    DP = (D + 3) / 4 * 4;
    KP = (D + 31) / 32 * 32 + 8;
    QV = q_tile * G;
    nt = (T + S - 1) / S;
    size_t o = 0;
    bar = o;  // rank 0's mbarrier (16 bytes keep q aligned)
    o += 16;
    qs = o;
    o += (size_t)QV * DP * 4;
    kb = o;
    o += (size_t)bs * KP * 4;
    vb = o;
    o += (size_t)bs * DP * 4;
    pw = o;
    o += (size_t)PA_MAX_WARPS * bs * 4;
    ml = o;
    o += (size_t)(S - 1) * QV * 2 * 4;
    acc = o;
    o += (size_t)(S - 1) * QV * D * 4;
    qp = o;
    o += (size_t)q_tile * 4;
    tb = o;
    o += (size_t)nt * 4;
    bytes = o;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// the address in rank 0's shared memory of this block's shared address a
__device__ __forceinline__ uint32_t at_rank0(uint32_t a) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(0));
  return r;
}

// Store into rank 0's shared memory; the bytes count toward rank 0's
// mbarrier `bar` when they land (no fence: the barrier counts them).
__device__ __forceinline__ void st_async(uint32_t addr, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
               ::"r"(addr), "r"(__float_as_uint(v)), "r"(bar)
               : "memory");
}

__device__ __forceinline__ void st_async2(uint32_t addr, float a, float b, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];\n"
      ::"r"(addr), "r"(__float_as_uint(a)), "r"(__float_as_uint(b)), "r"(bar)
      : "memory");
}

// arrive on `bar` and expect `bytes` of asynchronous stores this phase
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
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

// FAST: the serve shapes (bs = 16, D = 32 DI, aligned rows), where every
// loop over positions and dims has a trip count the compiler knows.
template <bool QUANT, int DI, bool FAST>
__global__ void __launch_bounds__(PA_MAX_WARPS * 32, 2)
paged_attn_kernel(const float* __restrict__ q, const void* __restrict__ kpool,
                  const void* __restrict__ vpool, const float* __restrict__ kscale,
                  const float* __restrict__ vscale, const int32_t* __restrict__ tables,
                  const int32_t* __restrict__ qpos, float* __restrict__ out, int C, int Hq,
                  int Hkv, int D, int bs, int T, int q_tile, bool vq, bool vkv) {
  if constexpr (FAST) {
    bs = 16;
    D = 32 * DI;
    vq = vkv = true;
  }
  constexpr int QMAX = qmax_for(DI);
  constexpr int ESZ = QUANT ? 1 : 4;  // bytes a K/V element
  constexpr int EPU = 16 / ESZ;       // elements a 16-byte unit
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int G = Hq / Hkv;
  const Layout ly(q_tile, G, D, bs, T, S);
  const uint32_t bar = smem_addr(smem + ly.bar);
  if (S > 1) {
    if (rank == 0 && threadIdx.x == 0) {  // the barrier the other ranks' partials land on
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    stream::cluster_arrive_relaxed();  // started, barrier set (waited on before DSMEM)
  }
  float* qs = reinterpret_cast<float*>(smem + ly.qs);
  float* kb = reinterpret_cast<float*>(smem + ly.kb);
  float* vb = reinterpret_cast<float*>(smem + ly.vb);
  float* sl_ml = reinterpret_cast<float*>(smem + ly.ml);
  float* sl_acc = reinterpret_cast<float*>(smem + ly.acc);
  int* qp_s = reinterpret_cast<int*>(smem + ly.qp);
  int* tb_s = reinterpret_cast<int*>(smem + ly.tb);
  const int b = blockIdx.x, h = blockIdx.y, c0 = (int)(blockIdx.z / S) * q_tile;
  const int nc = min(q_tile, C - c0), nq = nc * G;
  const int tid = threadIdx.x, nthr = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int NW = nthr >> 5;
  float* pr = reinterpret_cast<float*>(smem + ly.pw) + warp * bs;  // this warp's p row

  // 1. The tile's positions and this rank's table entries, all at once,
  // into registers; under their latency each thread places its K/V units
  // ((position, 16-byte column) packed as t << 16 | w, the same in every
  // table block) and its q units, then stores them.
  const int nt = (T - rank + S - 1) / S;  // rank < S <= T
  const int na = nc + nt;
  auto entry = [&](int i) {
    return i < nc ? qpos[(size_t)b * C + c0 + i]
                  : tables[(size_t)b * T + rank + (size_t)S * (i - nc)];
  };
  const int first = tid < na ? entry(tid) : 0;
  const int upr = vkv ? D / EPU : 0;  // 16-byte units a K/V row
  const int U = bs * upr;
  int unit[PA_RU];
#pragma unroll
  for (int i = 0; i < PA_RU; ++i) {
    const int u = tid + nthr * i;
    unit[i] = u < U ? (u / upr) << 16 | (u % upr) : -1;
  }
  const int row_bytes = Hkv * D * ESZ;  // one position of the pool
  const float sqrt_d = sqrtf((float)D);
  int TW = 1;  // positions a pass: the largest power of two <= min(bs, 32)
  while (2 * TW <= bs && TW < 32) TW *= 2;
  const int L = 32 / TW, PJ = (bs + TW - 1) / TW;
  const int tl = lane / L, cl = lane - tl * L;
  // q: the tile's rows start at q_base; unit u (4 floats) of query vector
  // qi = c G + g sits at (c Hq + g) D + 4 w there and at qi DP + 4 w in qs
  const size_t q_base = (((size_t)b * C + c0) * Hq + (size_t)h * G) * D;
  const int D4 = ly.DP / 4;
  int qsrc[2], qdst[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int u = tid + nthr * i;
    const int qi = u / D4, w = u - qi * D4, c = qi / G;
    qsrc[i] = u < nq * D4 ? (c * Hq + qi - c * G) * D + 4 * w : -1;
    qdst[i] = qi * ly.DP + 4 * w;
  }
  if (tid < na) {
    if (tid < nc)
      qp_s[tid] = first;
    else
      tb_s[tid - nc] = first;
  }
  for (int i = tid + nthr; i < na; i += nthr) {
    const int e = entry(i);
    if (i < nc)
      qp_s[i] = e;
    else
      tb_s[i - nc] = e;
  }
  __syncthreads();
  const int maxp = __reduce_max_sync(FULL, lane < nc ? qp_s[lane] : 0);
  const int nblk = min(T, maxp / bs + 1);  // whole-block skip past max(q_pos)
  const int nb = rank < nblk ? (nblk - rank + S - 1) / S : 0;  // this rank's blocks

  // 2. K/V staging: 16-byte units through registers, dequantized into
  // float rows of kb / vb; units past the register stage, and every element
  // when rows are not 16-byte aligned, load as they are stored.
  const unsigned char* kbytes = static_cast<const unsigned char*>(kpool);
  const unsigned char* vbytes = static_cast<const unsigned char*>(vpool);
  uint4 rk[PA_RU], rv[PA_RU];
  float rks[PA_RU], rvs[PA_RU];
  auto load_regs = [&](int phys) {
    const size_t row0 = (size_t)phys * bs * Hkv + h;  // the block's position 0, head h
    const unsigned char* kp = kbytes + row0 * D * ESZ;
    const unsigned char* vp = vbytes + row0 * D * ESZ;
#pragma unroll
    for (int i = 0; i < PA_RU; ++i) {
      if (unit[i] >= 0) {
        const int t = unit[i] >> 16, off = t * row_bytes + 16 * (unit[i] & 0xffff);
        rk[i] = __ldg(reinterpret_cast<const uint4*>(kp + off));
        rv[i] = __ldg(reinterpret_cast<const uint4*>(vp + off));
        if constexpr (QUANT) {
          rks[i] = __ldg(kscale + row0 + t * Hkv);
          rvs[i] = __ldg(vscale + row0 + t * Hkv);
        }
      }
    }
  };
  auto put = [&](float* dst, uint4 raw, float sc) {
    if constexpr (QUANT) {
      const uint32_t wd[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float4 f;
        f.x = (float)(int8_t)(wd[j] & 0xffu) * sc;
        f.y = (float)(int8_t)((wd[j] >> 8) & 0xffu) * sc;
        f.z = (float)(int8_t)((wd[j] >> 16) & 0xffu) * sc;
        f.w = (float)(int8_t)(wd[j] >> 24) * sc;
        reinterpret_cast<float4*>(dst)[j] = f;
      }
    } else {
      *reinterpret_cast<float4*>(dst) = make_float4(
          __uint_as_float(raw.x), __uint_as_float(raw.y), __uint_as_float(raw.z),
          __uint_as_float(raw.w));
    }
  };
  auto store = [&](int phys) {
    if (vkv) {
#pragma unroll
      for (int i = 0; i < PA_RU; ++i) {
        if (unit[i] >= 0) {
          const int t = unit[i] >> 16, w = unit[i] & 0xffff;
          put(kb + t * ly.KP + w * EPU, rk[i], QUANT ? rks[i] : 1.f);
          put(vb + t * ly.DP + w * EPU, rv[i], QUANT ? rvs[i] : 1.f);
        }
      }
      for (int u = tid + nthr * PA_RU; u < U; u += nthr) {
        const int t = u / upr, w = u - t * upr;
        const size_t row = ((size_t)phys * bs + t) * Hkv + h;
        const uint4 a = __ldg(reinterpret_cast<const uint4*>(kbytes + row * D * ESZ) + w);
        const uint4 c = __ldg(reinterpret_cast<const uint4*>(vbytes + row * D * ESZ) + w);
        put(kb + t * ly.KP + w * EPU, a, QUANT ? __ldg(kscale + row) : 1.f);
        put(vb + t * ly.DP + w * EPU, c, QUANT ? __ldg(vscale + row) : 1.f);
      }
    } else {
      for (int e = tid; e < bs * D; e += nthr) {
        const int t = e / D, d = e - t * D;
        const size_t row = ((size_t)phys * bs + t) * Hkv + h, idx = row * D + d;
        float kv, vv;
        if constexpr (QUANT) {
          kv = (float)static_cast<const int8_t*>(kpool)[idx] * kscale[row];
          vv = (float)static_cast<const int8_t*>(vpool)[idx] * vscale[row];
        } else {
          kv = static_cast<const float*>(kpool)[idx];
          vv = static_cast<const float*>(vpool)[idx];
        }
        kb[t * ly.KP + d] = kv;
        vb[t * ly.DP + d] = vv;
      }
      const int pad = ly.DP - D;  // scores read K rows as float4s up to DP
      for (int e = tid; e < bs * pad; e += nthr) kb[(e / pad) * ly.KP + D + e % pad] = 0.f;
    }
  };
  auto stage_q = [&]() {
    if (vq) {
      float4 qv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (qsrc[i] >= 0) qv[i] = __ldg(reinterpret_cast<const float4*>(q + q_base + qsrc[i]));
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (qsrc[i] >= 0) *reinterpret_cast<float4*>(qs + qdst[i]) = qv[i];
      for (int u = tid + 2 * nthr; u < nq * D4; u += nthr) {
        const int qi = u / D4, w = u - qi * D4, c = qi / G;
        reinterpret_cast<float4*>(qs + qi * ly.DP)[w] = __ldg(
            reinterpret_cast<const float4*>(q + q_base + (c * Hq + qi - c * G) * D) + w);
      }
    } else {
      for (int e = tid; e < nq * ly.DP; e += nthr) {
        const int qi = e / ly.DP, d = e - qi * ly.DP, c = qi / G, g = qi - c * G;
        qs[e] = d < D ? q[(((size_t)b * C + c0 + c) * Hq + (size_t)h * G + g) * D + d] : 0.f;
      }
    }
  };

  // 3. The walk: this rank's blocks rank, rank + S, ... in turn.
  float m[QMAX], l[QMAX], acc[QMAX][DI];
#pragma unroll
  for (int k = 0; k < QMAX; ++k) {
    m[k] = PA_NEG_INF;
    l[k] = 0.f;
#pragma unroll
    for (int e = 0; e < DI; ++e) acc[k][e] = 0.f;
  }
  if (nb > 0) {
    load_regs(tb_s[0]);  // K/V in flight before q is staged
    stage_q();
  }
  int qpc[QMAX];  // each query vector's position
#pragma unroll
  for (int k = 0; k < QMAX; ++k) {
    const int qi = warp + NW * k;
    qpc[k] = qi < nq ? qp_s[qi / G] : 0;
  }
  for (int i = 0; i < nb; ++i) {
    const int jblk = rank + S * i;  // logical block of the row
    if (i > 0) __syncthreads();     // the previous block's K/V are consumed
    store(tb_s[i]);
    __syncthreads();
    if (i + 1 < nb) load_regs(tb_s[i + 1]);  // the next block, in flight meanwhile
#pragma unroll
    for (int k = 0; k < QMAX; ++k) {
      const int qi = warp + NW * k;
      if (qi >= nq) break;  // warp-uniform
      const float4* q4 = reinterpret_cast<const float4*>(qs + qi * ly.DP);
      // scores: lane (tl, cl) takes position tl + TW j, dims cl, cl + L, ...
      float s[PA_PMAX];
      bool ok[PA_PMAX];
      float bmax = PA_NEG_INF;
#pragma unroll
      for (int j = 0; j < PA_PMAX; ++j) {
        s[j] = PA_NEG_INF;
        ok[j] = false;
        if (j < PJ) {
          const int t = tl + TW * j;
          float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
          if (t < bs) {
            const float4* k4 = reinterpret_cast<const float4*>(kb + t * ly.KP);
#pragma unroll
            for (int it = 0; it < (D4 + L - 1) / L; ++it) {
              const int ch = cl + L * it;
              if (ch >= D4) break;
              const float4 x = q4[ch], y = k4[ch];
              a.x = fmaf(x.x, y.x, a.x);
              a.y = fmaf(x.y, y.y, a.y);
              a.z = fmaf(x.z, y.z, a.z);
              a.w = fmaf(x.w, y.w, a.w);
            }
          }
          float dot = (a.x + a.y) + (a.z + a.w);
#pragma unroll
          for (int o = 1; o < 32; o <<= 1)
            if (o < L) dot += __shfl_xor_sync(FULL, dot, o);
          ok[j] = t < bs && jblk * bs + t <= qpc[k];
          if (ok[j]) s[j] = dot / sqrt_d;
          bmax = fmaxf(bmax, s[j]);
        }
      }
#pragma unroll
      for (int o = 1; o < 32; o <<= 1)
        if (o >= L) bmax = fmaxf(bmax, __shfl_xor_sync(FULL, bmax, o));
      const float m_new = fmaxf(m[k], bmax);
      const float alpha = expf(m[k] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < PA_PMAX; ++j) {
        const float pj = ok[j] ? expf(s[j] - m_new) : 0.f;  // a masked position adds nothing
        psum += pj;
        const int t = tl + TW * j;
        if (j < PJ && cl == 0 && t < bs) pr[t] = pj;
      }
#pragma unroll
      for (int o = 1; o < 32; o <<= 1)
        if (o >= L) psum += __shfl_xor_sync(FULL, psum, o);
      m[k] = m_new;
      l[k] = alpha * l[k] + psum;
      __syncwarp();  // the warp's p row is written
      // p @ V: lane owns dims lane, lane + 32, ...; p read back from the row
#pragma unroll
      for (int e = 0; e < DI; ++e) acc[k][e] *= alpha;
#pragma unroll
      for (int t = 0; t < bs; ++t) {
        const float pt = pr[t];
        const float* vr = vb + t * ly.DP + lane;
#pragma unroll
        for (int e = 0; e < DI; ++e)
          if (lane + 32 * e < D) acc[k][e] = fmaf(pt, vr[32 * e], acc[k][e]);
      }
      __syncwarp();  // read before the next query vector writes the row
    }
  }

  // 4. The merge: ranks 1.. store their partials into rank 0's slots
  // (st.async onto rank 0's mbarrier) and leave; rank 0 waits for the bytes
  // and adds the ranks in rank order.
  if (S > 1) {
    const int live = min(S, nblk);
    if (rank > 0) {
      if (rank < live) {
        stream::cluster_wait();  // rank 0 has started and set its barrier
        const uint32_t rbar = at_rank0(bar);
        const uint32_t rml = at_rank0(smem_addr(sl_ml)), racc = at_rank0(smem_addr(sl_acc));
#pragma unroll
        for (int k = 0; k < QMAX; ++k) {
          const int qi = warp + NW * k;
          if (qi >= nq) break;
          const int slot = (rank - 1) * ly.QV + qi;
          if (lane == 0) st_async2(rml + 8 * slot, m[k], l[k], rbar);
#pragma unroll
          for (int e = 0; e < DI; ++e)
            if (lane + 32 * e < D) st_async(racc + 4 * (slot * D + lane + 32 * e), acc[k][e], rbar);
        }
      }
      return;
    }
    if (live > 1) {
      if (tid == 0) mbar_expect(bar, (live - 1) * nq * (2 + D) * 4);
      mbar_wait(bar, 0);  // every live rank's partials are in the slots
#pragma unroll
      for (int k = 0; k < QMAX; ++k) {
        const int qi = warp + NW * k;
        if (qi >= nq) break;
        // lane r < live holds rank r's (m_r, l_r) and its weight a_r
        float2 mr = make_float2(PA_NEG_INF, 0.f);
        if (lane == 0)
          mr = make_float2(m[k], l[k]);
        else if (lane < live)
          mr = *reinterpret_cast<const float2*>(sl_ml + 2 * ((lane - 1) * ly.QV + qi));
        float ms = mr.x;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) ms = fmaxf(ms, __shfl_xor_sync(FULL, ms, o));
        const float a = lane < live ? expf(mr.x - ms) : 0.f;
        const float a0 = expf(m[k] - ms);  // lane 0's a: rank 0's own weight
        float lsum = a0 * l[k], o[DI];
#pragma unroll
        for (int e = 0; e < DI; ++e) o[e] = a0 * acc[k][e];
        // rank order; a rank past `live` adds +0 (a = l = 0, its slot unread)
#pragma unroll
        for (int r = 1; r < PA_MAX_SPLITS; ++r) {
          const float ar = __shfl_sync(FULL, a, r), lr = __shfl_sync(FULL, mr.y, r);
          lsum += ar * lr;
          const float* src = sl_acc + ((size_t)(r - 1) * ly.QV + qi) * D + lane;
#pragma unroll
          for (int e = 0; e < DI; ++e)
            o[e] += ar * (r < live && lane + 32 * e < D ? src[32 * e] : 0.f);
        }
        l[k] = lsum;
#pragma unroll
        for (int e = 0; e < DI; ++e) acc[k][e] = o[e];
      }
    }
  }
  // kv position 0 is always <= q_pos and lies in rank 0's block 0: l > 0
#pragma unroll
  for (int k = 0; k < QMAX; ++k) {
    const int qi = warp + NW * k;
    if (qi >= nq) break;
    const int c = qi / G, g = qi - c * G;
    float* dst = out + (((size_t)b * C + c0 + c) * Hq + (size_t)h * G + g) * D + lane;
#pragma unroll
    for (int e = 0; e < DI; ++e)
      if (lane + 32 * e < D) dst[32 * e] = acc[k][e] / l[k];
  }
}

// Blocks of `threads` threads and `smem` bytes an SM keeps (228 KB of
// shared memory with 1 KB a block reserved, 2,048 threads, 64 K registers at
// the kernel's 128 a thread, 32 blocks).
int resident_per_sm(size_t smem, int threads) {
  const int by_smem = (int)(233472 / (smem + 1024));
  const int by_threads = 2048 / threads, by_regs = 65536 / (128 * threads);
  return std::min(std::min(by_smem, by_threads), std::min(by_regs, 32));
}

// Whether `blocks` such blocks, in clusters, are one wave of the card: 7/8
// of the SMs' sum, for clusters place less densely (the streaming kernels'
// clusters of 8 keep 240 of the 264 blocks two an SM would give).
bool one_wave(long long blocks, size_t smem, int threads) {
  return 8 * blocks <= 7LL * PA_SMS * resident_per_sm(smem, threads);
}

// The query tile that fits a cluster of S: at most PA_QTILE tokens, the
// tiles of a chunk as even as they can be, fewer where the tile's query
// vectors would pass the registers of 8 warps or the slots two blocks an SM,
// down to one token, which may take an SM alone; 0 if none fits.
int fit_tile(int C, int G, int D, int bs, int T, int S) {
  const int cap = PA_MAX_WARPS * qmax_for(dims_per_lane(D));
  const int tiles = (C + PA_QTILE - 1) / PA_QTILE;
  int qt = (C + tiles - 1) / tiles;
  while (qt > 1 && (qt * G > cap || Layout(qt, G, D, bs, T, S).bytes > PA_SMEM_BUDGET)) --qt;
  return qt * G <= cap && Layout(qt, G, D, bs, T, S).bytes <= PA_SMEM_MAX ? qt : 0;
}

// The plan of a call: a cluster of `splits` = min(T, 8) ranks, or min(T,
// 16) when T > 8 and the grid of 16-rank clusters, at the same query tile,
// is one wave of the card; `q_tile` one token where the grid of one-token
// tiles is one wave, else from fit_tile. False for a shape the kernel does
// not take (D > 256, bs > 128, ...). The same rule is
// repro_torch.kernels.paged_attn.attn_plan; the card tests hold them equal.
bool attn_plan(int B, int C, int Hq, int Hkv, int D, int bs, int T, int* q_tile, int* splits) {
  if (B <= 0 || C <= 0 || Hkv <= 0 || Hq <= 0 || Hq % Hkv != 0 || D <= 0 || D > PA_MAX_D ||
      bs <= 0 || bs > PA_MAX_BS || T <= 0)
    return false;
  const int G = Hq / Hkv;
  int S = T < PA_SPLITS ? T : PA_SPLITS;
  int qt = fit_tile(C, G, D, bs, T, S);
  if (qt == 0) return false;
  if (qt > 1 && one_wave((long long)B * Hkv * C * S, Layout(1, G, D, bs, T, S).bytes,
                         32 * std::min(PA_MAX_WARPS, G)))
    qt = 1;  // one token a tile (one query vector a warp) where that grid is one wave
  if (T > PA_SPLITS) {
    const int S16 = T < PA_MAX_SPLITS ? T : PA_MAX_SPLITS;
    const int threads = 32 * std::min(PA_MAX_WARPS, std::min(qt, C) * G);
    const long long blocks = (long long)B * Hkv * ((C + qt - 1) / qt) * S16;
    if (fit_tile(C, G, D, bs, T, S16) == qt &&
        one_wave(blocks, Layout(qt, G, D, bs, T, S16).bytes, threads))
      S = S16;
  }
  *q_tile = qt;
  *splits = S;
  return true;
}

typedef void (*KernelFn)(const float*, const void*, const void*, const float*, const float*,
                         const int32_t*, const int32_t*, float*, int, int, int, int, int, int,
                         int, bool, bool);

template <bool QUANT, bool FAST>
KernelFn kernel_of(int di) {
  switch (di) {
    case 1: return paged_attn_kernel<QUANT, 1, FAST>;
    case 2: return paged_attn_kernel<QUANT, 2, FAST>;
    case 4: return paged_attn_kernel<QUANT, 4, FAST>;
    default: return paged_attn_kernel<QUANT, 8, FAST>;
  }
}

KernelFn kernel_for(bool quant, int di, bool fast) {
  if (quant) return fast ? kernel_of<true, true>(di) : kernel_of<true, false>(di);
  return fast ? kernel_of<false, true>(di) : kernel_of<false, false>(di);
}

// The launch configuration of a plan; false if the plan does not fit.
bool configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute (&attr)[1], int B, int C, int Hq,
               int Hkv, int D, int bs, int T, int q_tile, int splits) {
  if (B <= 0 || C <= 0 || Hkv <= 0 || Hq <= 0 || Hq % Hkv != 0 || D <= 0 || D > PA_MAX_D ||
      bs <= 0 || bs > PA_MAX_BS || T <= 0 || q_tile < 1 || q_tile > PA_MAX_QTILE ||
      splits < 1 || splits > PA_MAX_SPLITS || splits > T)
    return false;
  const int G = Hq / Hkv;
  const int nq_max = (q_tile < C ? q_tile : C) * G;
  if (q_tile * G > PA_MAX_WARPS * qmax_for(dims_per_lane(D))) return false;
  const Layout ly(q_tile, G, D, bs, T, splits);
  if (ly.bytes > PA_SMEM_MAX) return false;
  cfg = {};
  cfg.gridDim = dim3(B, Hkv, ((C + q_tile - 1) / q_tile) * splits);
  cfg.blockDim = dim3(32 * (nq_max < PA_MAX_WARPS ? nq_max : PA_MAX_WARPS));
  cfg.dynamicSmemBytes = ly.bytes;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return true;
}

// Lets `fn` take a block's most shared memory and clusters of 16, once.
cudaError_t prepare(KernelFn fn) {
  static KernelFn done[16];
  static int n_done = 0;
  for (int i = 0; i < n_done; ++i)
    if (done[i] == fn) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)PA_SMEM_MAX);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && n_done < 16) done[n_done++] = fn;
  return err;
}

int launch(const void* q, const void* k, const void* v, const void* kscale, const void* vscale,
           const void* tables, const void* qpos, void* out, int B, int C, int Hq, int Hkv, int D,
           int bs, int T, int quantized, int q_tile, int splits, void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  if (!configure(cfg, attr, B, C, Hq, Hkv, D, bs, T, q_tile, splits))
    return (int)cudaErrorInvalidValue;
  cfg.stream = static_cast<cudaStream_t>(stream);
  const bool quant = quantized != 0;
  const int esz = quant ? 1 : 4;
  const bool vq = D % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const bool vkv = (D * esz) % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16) == 0;
  const int di = dims_per_lane(D);
  const KernelFn fn = kernel_for(quant, di, bs == 16 && D == 32 * di && vq && vkv);
  cudaError_t err = prepare(fn);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, fn, static_cast<const float*>(q), k, v,
                           static_cast<const float*>(kscale), static_cast<const float*>(vscale),
                           static_cast<const int32_t*>(tables), static_cast<const int32_t*>(qpos),
                           static_cast<float*>(out), C, Hq, Hkv, D, bs, T, q_tile, vq, vkv);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// q (B, C, Hq, D) f32; k/v one pool layer (n_phys, bs, Hkv, D), f32 or int8
// with (n_phys, bs, Hkv, 1) f32 scales (quantized != 0); tables (B, T) int32;
// qpos (B, C) int32 -> out (B, C, Hq, D) f32. Launches on `stream` by the
// plan (attn_plan), does not synchronise, returns the launch's error or
// cudaErrorInvalidValue for a shape it does not take.
extern "C" int paged_attn_launch(const void* q, const void* k, const void* v, const void* kscale,
                                 const void* vscale, const void* tables, const void* qpos,
                                 void* out, int B, int C, int Hq, int Hkv, int D, int bs, int T,
                                 int quantized, void* stream) {
  int q_tile = 0, splits = 0;
  if (!attn_plan(B, C, Hq, Hkv, D, bs, T, &q_tile, &splits)) return (int)cudaErrorInvalidValue;
  return launch(q, k, v, kscale, vscale, tables, qpos, out, B, C, Hq, Hkv, D, bs, T, quantized,
                q_tile, splits, stream);
}

// The same with the caller's plan (sweeps): `q_tile` query tokens a block,
// a cluster of `splits` (1..16, at most T; above 8 a non-portable cluster).
extern "C" int paged_attn_launch_plan(const void* q, const void* k, const void* v,
                                      const void* kscale, const void* vscale, const void* tables,
                                      const void* qpos, void* out, int B, int C, int Hq, int Hkv,
                                      int D, int bs, int T, int quantized, int q_tile, int splits,
                                      void* stream) {
  return launch(q, k, v, kscale, vscale, tables, qpos, out, B, C, Hq, Hkv, D, bs, T, quantized,
                q_tile, splits, stream);
}

// The plan of a shape into plan[0..3]: q_tile, splits, shared memory bytes
// a block, threads a block. Returns 0, or cudaErrorInvalidValue for a shape
// the kernel does not take.
extern "C" int paged_attn_plan(int B, int C, int Hq, int Hkv, int D, int bs, int T, int* plan) {
  int q_tile = 0, splits = 0;
  if (!attn_plan(B, C, Hq, Hkv, D, bs, T, &q_tile, &splits)) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  configure(cfg, attr, B, C, Hq, Hkv, D, bs, T, q_tile, splits);
  plan[0] = q_tile;
  plan[1] = splits;
  plan[2] = (int)cfg.dynamicSmemBytes;
  plan[3] = (int)cfg.blockDim.x;
  return 0;
}

// Blocks of a plan the card keeps resident at once (its cluster occupancy
// times splits), or -1 if it cannot say.
extern "C" int paged_attn_max_blocks(int B, int C, int Hq, int Hkv, int D, int bs, int T,
                                     int quantized, int q_tile, int splits) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  if (!configure(cfg, attr, B, C, Hq, Hkv, D, bs, T, q_tile, splits)) return -1;
  const int di = dims_per_lane(D);
  const KernelFn fn = kernel_for(quantized != 0, di, bs == 16 && D == 32 * di);
  if (prepare(fn) != cudaSuccess) return -1;
  int clusters = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
  return err == cudaSuccess ? clusters * splits : -1;
}
