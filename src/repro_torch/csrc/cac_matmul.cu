// Hardware-form BiKA comparator-accumulate (CAC) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/cac_matmul.py :: cac_matmul_kernel_call
//           (Pallas body _cac_fwd_kernel), the serve-path CAC the reference
//           reaches through kernels/ops.py :: cac_matmul.
//
// Computes  y[m, n] = sum_k (x[m, k] >= tau[k, n] ? s[k, n] : -s[k, n])
//   x    (M, K)    int8   activations already on the threshold grid
//   tau  (K, N)    int8   thresholds
//   s    (K/8, N)  uint8  packed sign planes: bit j of byte r is row 8r+j,
//                         1 -> +1, 0 -> -1 (the serve form, read as is)
//   y    (M, N)    float  exact integer sums (|y| <= K < 2^24)
//
// What bounds it on the H100: there is no tensor-core form of a compare and
// select. At the serve path's shapes (M = 4 at decode, 32 in a prefill
// chunk) the bytes are tau and s (1.125 B per edge, 2.8 MB at the gate/up
// projection, 0.84 us at 3.35 TB/s), read once; at M = 4 a pass over them
// is bound by the latency of the loads, at M = 32 by the integer compares.
//
// Design: stream_matmul.cuh's streaming template (op CAC), shared with the
// sign product's small-M route: tau read 16 columns a 16-byte load and s 16
// columns (8 K rows) a load, the compares done four columns a word in byte
// lanes (a term is +1 exactly when [x >= tau] equals the s bit, so y = K -
// 2 * mismatches), K split over the warps of a block and, where the tiles
// are few, over a cluster whose partial counts meet in distributed shared
// memory in rank order. One launch, no memset, no atomics; bit-exact and
// repeatable. It serves every M: a larger M than the path's takes ceil(M /
// 16) row tiles, each reading tau and s again (from L2). Ragged M and N are
// masked here (N not a multiple of 16 takes byte loads); K % 8 == 0.
#include "stream_matmul.cuh"

// x (M, K) int8, tau (K, N) int8, s (K/8, N) uint8 -> y (M, N) float, by the
// caller's plan (repro_torch.kernels.cac_matmul.stream_plan): `mt` rows a
// tile (4 or 16), `splits` blocks a cluster, each taking `groups_per_split`
// of the K/8 row groups. Writes every element of y, launches on `stream`,
// does not synchronise, returns the launch's error, or cudaErrorInvalidValue
// for a plan or shape it does not take.
extern "C" int cac_matmul_launch(const void* x, const void* tau, const void* s, void* y,
                                 int M, int N, int K, int mt, int splits, int groups_per_split,
                                 void* stream) {
  if (K % 8 != 0) return (int)cudaErrorInvalidValue;
  const cudaError_t err = stream::launch<stream::CAC>(
      x, tau, static_cast<const uint8_t*>(s), static_cast<float*>(y), M, N, K, mt, splits,
      groups_per_split, static_cast<cudaStream_t>(stream));
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// Resident blocks of the kernel with `mt`-row tiles in clusters of `splits`
// (the plan weighs waves with it); -1 if the card cannot say.
extern "C" int stream_max_blocks(int mt, int splits) {
  return stream::max_blocks<stream::CAC>(mt, splits);
}
