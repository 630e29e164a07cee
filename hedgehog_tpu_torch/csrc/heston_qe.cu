// QE mixing kernels for sm_90a: per-path values (K7) and the accumulating
// serving price (K8).
//
// Replaces hedgehog_tpu/ops/heston_qe_kernel.py:
//   heston_qe_mixing_values         (pallas_call at :774 QMC, :794 PRNG;
//                                    bodies _qe_mixing_values_kernel[_qmc])
//   heston_qe_mixing_vanilla_price  (pallas_call at :904 QMC, :925 PRNG;
//                                    bodies _qe_mixing_price_kernel[_qmc])
//
// Per step a path draws one normal and one uniform, moves V by the QE
// scheme (quadratic or exponential branch), adds the trapezoid to IV and
// the exact-identity increment to J; the path closes with the conditional
// Black-Scholes formula.  The plain PyTorch twin is
// hedgehog_tpu_torch/ops/heston_qe_kernel.py; keep the two in step.
//
// What bounds it on this card: FP32 and special-function issue (per step
// and path two or three polished reciprocals, a square root or a log, and
// for the stream a Sobol' XOR walk or half a Philox call and Box-Muller),
// not memory: K7 writes 4 bytes per path, K8 one double per block.  The
// design keeps one antithetic pair per thread with (v, IV, J) of both paths
// in registers, evaluates only the QE branch a lane takes (the TPU kernel
// computes both and selects), and for K8 runs one resident wave of blocks
// that each walk a fixed stride of pairs.  K8 sums in fp32 per thread and in
// float64 per block (heston_qe.cuh block_sums, the tree the greek kernel
// K10 uses for its price column), so K10's price equals K8's to the bit.
// A warp issues about one instruction a clock here, so what K8's redesign
// saves is instructions.  K8 is compiled once per stream, so its Philox
// build holds no Sobol' state; under QMC it draws as K10 does
// (heston_qe.cuh draw_steps: each Sobol' integer split at bit 5, the warp's
// high words staged once a round).  Its grid (hh_qe_price_grid) is
// kPriceBlocks an SM, fewer only where the shared memory of K8's launch
// leaves room for fewer: one wave of K8 and K10, whatever registers either
// takes.  Two threads a pair (one path each, the draws shared by shuffles)
// ran 1.10x slower on an H100 (PERF.md).  K7 is built once per stream, one
// pair a thread, and draws K8's split Sobol' integers where the staged
// table and high words keep hh::kStagedBlocks blocks an SM.

#include "heston_qe.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPriceBlocks = 3;  // K8's and K10's blocks an SM: their grid, one wave of both

// K7 on one stream (kQmc 1: the Sobol' table, 0: Philox), one pair a
// thread: thread i walks pair i (Sobol' point point_offset + i) and writes
// its value to out[i] and, under antithetic pairing, its antithetic value
// to out[n_paths + i].  Staged under QMC, it draws as K8 does (heston_qe.cuh
// draw_steps, the warp's high words staged by hh::stage_high), so every
// lane of the last, ragged warp stages before the lanes past n_paths drop
// out; the global-table build (kStaged false) forms the same integers
// through sobol_bits.  The pairing stays a run-time test: a build per
// pairing saved 4 of 554 instructions a PRNG loop of two steps, and launch
// bounds of 5 or 6 blocks an SM did not pay (PERF.md §6).
template <bool kStaged, int kQmc>
__global__ void __launch_bounds__(kThreads)
qe_values_kernel(const float* __restrict__ params, const int* __restrict__ sobol,
                 float* __restrict__ out, long long n_paths, int steps, int antithetic,
                 uint32_t seed, uint32_t device_id, long long point_offset) {
  __shared__ hh::MixParams sp;
  extern __shared__ int ssob[];
  const int* staged =
      hh::stage_inputs<0, 2, hh::MixParams, kStaged>(params, nullptr, sobol, steps, sp, nullptr, ssob);
  const int* table = kQmc ? staged : nullptr;
  if constexpr (kQmc == 1) __builtin_assume(table != nullptr);
  const long long base = (long long)blockIdx.x * blockDim.x;
  const long long i = base + threadIdx.x;
  const uint32_t p0 = (uint32_t)(point_offset + base) + (threadIdx.x & ~31u);
  uint32_t* hw = hh::warp_high_words(ssob, 2 * steps);
  if (kStaged && kQmc) hh::stage_high(table, 2 * steps, p0, hw);
  if (i >= n_paths) return;
  const int c = (int)(((p0 & 31u) + (threadIdx.x & 31u)) >> 5);
  float v = sp.v0, iv = 0.0f, j = 0.0f, va = sp.v0, iva = 0.0f, ja = 0.0f;
  const auto step = [&](float z, float u) {
    hh::mix_advance(v, iv, j, z, u, sp);
    if (antithetic) hh::mix_advance(va, iva, ja, -z, 1.0f - u, sp);
  };
  if constexpr (kQmc == 1) {
    float z_odd = 0.0f;
    uint32_t w_odd = 0u;
    hh::draw_steps<true, kStaged>((unsigned long long)i, (uint32_t)(point_offset + i), table, hw,
                                  c, 0u, 0u, 0, steps, z_odd, w_odd, step);
  } else {
    hh::mix_draws((unsigned long long)i, nullptr, steps, seed, device_id, 0, step);
  }
  out[i] = hh::cond_bs_value(iv, j, sp.close);
  if (antithetic) out[n_paths + i] = hh::cond_bs_value(iva, ja, sp.close);
}

// K8's body on one stream (kQmc 1: the Sobol' table, 0: Philox), K10's walk
// without the tangents: the grid-stride round is uniform over the block, so
// every lane of a warp stages its round's high Sobol' words
// (hh::stage_high) before the lanes past the last pair drop out, and a
// thread walks the pairs and sums them in the order of one pair a thread.
template <bool kStaged, int kQmc>
__device__ __forceinline__ void price_body(const float* params, const int* sobol,
                                           double* partials, long long total_pairs, int steps,
                                           uint32_t seed, uint32_t device_id,
                                           long long point_offset, hh::MixParams& sp,
                                           double* red, int* ssob) {
  const int* staged =
      hh::stage_inputs<0, 2, hh::MixParams, kStaged>(params, nullptr, sobol, steps, sp, nullptr, ssob);
  const int* table = kQmc ? staged : nullptr;
  if constexpr (kQmc == 1) __builtin_assume(table != nullptr);
  // this warp's high words past the table: 2 candidates of each of the
  // 2 * steps dimensions
  uint32_t* hw = reinterpret_cast<uint32_t*>(ssob + 2 * steps * (hh::kSobolBits + 1)) +
                 (threadIdx.x >> 5) * 4 * steps;
  float acc[1] = {0.0f};
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long base = (long long)blockIdx.x * blockDim.x; base < total_pairs; base += stride) {
    const long long g = base + threadIdx.x;
    const uint32_t p0 = (uint32_t)(point_offset + base) + (threadIdx.x & ~31u);
    if (kStaged && kQmc) hh::stage_high(table, 2 * steps, p0, hw);
    if (g >= total_pairs) continue;
    const int c = (int)(((p0 & 31u) + (threadIdx.x & 31u)) >> 5);
    float v = sp.v0, iv = 0.0f, j = 0.0f, va = sp.v0, iva = 0.0f, ja = 0.0f;
    const auto step = [&](float z, float u) {
      hh::mix_advance(v, iv, j, z, u, sp);
      hh::mix_advance(va, iva, ja, -z, 1.0f - u, sp);
    };
    if constexpr (kQmc == 1) {
      float z_odd = 0.0f;
      uint32_t w_odd = 0u;
      hh::draw_steps<true, kStaged>((unsigned long long)g, (uint32_t)(point_offset + g), table,
                                    hw, c, 0u, 0u, 0, steps, z_odd, w_odd, step);
    } else {
      hh::mix_draws((unsigned long long)g, nullptr, steps, seed, device_id, 0, step);
    }
    acc[0] += hh::cond_bs_value(iv, j, sp.close) + hh::cond_bs_value(iva, ja, sp.close);
  }
  hh::block_sums<kThreads>(acc, red, partials);
}

// K8, one body per stream, built for kPriceBlocks blocks an SM.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads, kPriceBlocks)
qe_price_kernel(const float* __restrict__ params, const int* __restrict__ sobol,
                double* __restrict__ partials, long long total_pairs, int steps, uint32_t seed,
                uint32_t device_id, long long point_offset) {
  __shared__ hh::MixParams sp;
  __shared__ double red[kThreads];
  extern __shared__ int ssob[];
  if (sobol) {
    price_body<kStaged, 1>(params, sobol, partials, total_pairs, steps, seed, device_id,
                           point_offset, sp, red, ssob);
  } else {
    price_body<kStaged, 0>(params, sobol, partials, total_pairs, steps, seed, device_id,
                           point_offset, sp, red, ssob);
  }
}

// K8's launch at `steps` steps on one stream: under QMC the staged kernel
// with the table and each warp's high words in dynamic shared memory where
// they fit a block, else the kernel that reads the table from global memory.
// Its launch, grid and occupancy all follow this one decision.
struct PriceLaunch {
  bool staged;
  size_t smem;
};

PriceLaunch price_launch(bool qmc, int steps) {
  const size_t smem = qmc ? sizeof(int) * 2 * steps * (hh::kSobolBits + 1) +
                                sizeof(uint32_t) * (kThreads / 32) * 4 * steps
                          : 0;
  if (smem <= hh::smem_room(qe_price_kernel<true>)) return {true, smem};
  return {false, 0};
}

// K8's resident blocks an SM at `launch` (after opting the staged kernel
// into its shared memory).
cudaError_t price_blocks_per_sm(const PriceLaunch& launch, int* per_sm) {
  if (!launch.staged) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, qe_price_kernel<false>,
                                                         kThreads, 0);
  }
  const cudaError_t err = hh::allow_dynamic_smem(qe_price_kernel<true>, launch.smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, qe_price_kernel<true>, kThreads,
                                                       launch.smem);
}

}  // namespace

// Per-path undiscounted values: out is (1 or 2, n_paths) float32.  Under
// QMC the staged build (the table and each warp's high words in dynamic
// shared memory, the split draw) where it keeps hh::kStagedBlocks blocks an
// SM, else the build that reads the table from global memory.
extern "C" int hh_qe_values(const float* params, const int* sobol, float* out, long long n_paths,
                            int steps, int antithetic, unsigned seed, unsigned device_id,
                            long long point_offset, void* stream) {
  const unsigned blocks = (unsigned)((n_paths + kThreads - 1) / kThreads);
  const auto run = [&](auto kernel, size_t smem) {
    kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
        params, sobol, out, n_paths, steps, antithetic, seed, device_id, point_offset);
    return (int)cudaGetLastError();
  };
  if (!sobol) return run(qe_values_kernel<false, 0>, 0);
  const size_t smem = hh::split_smem(2 * steps, kThreads);
  bool staged = false;
  const cudaError_t err = hh::split_fits(qe_values_kernel<true, 1>, kThreads, smem, &staged);
  if (err != cudaSuccess) return (int)err;
  return staged ? run(qe_values_kernel<true, 1>, smem) : run(qe_values_kernel<false, 1>, 0);
}

// Sums of (value + antithetic value): partials is (grid,) float64, one per
// block.  The Sobol' table and the warps' high words are staged in shared
// memory where they fit a block, else the table is read from global memory.
extern "C" int hh_qe_price(const float* params, const int* sobol, double* partials, int grid,
                           long long total_pairs, int steps, unsigned seed, unsigned device_id,
                           long long point_offset, void* stream) {
  const PriceLaunch launch = price_launch(sobol != nullptr, steps);
  if (launch.staged) {
    const cudaError_t err = hh::allow_dynamic_smem(qe_price_kernel<true>, launch.smem);
    if (err != cudaSuccess) return (int)err;
    qe_price_kernel<true><<<grid, kThreads, launch.smem, (cudaStream_t)stream>>>(
        params, sobol, partials, total_pairs, steps, seed, device_id, point_offset);
  } else {
    qe_price_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        params, sobol, partials, total_pairs, steps, seed, device_id, point_offset);
  }
  return (int)cudaGetLastError();
}

// K8's occupancy on the current device at `steps` steps, QMC (its table and
// high words staged where they fit a block) or Philox: out = (threads a
// block, resident blocks per SM, SMs, dynamic shared bytes, static shared
// bytes, registers a thread, local (spill) bytes a thread).
extern "C" int hh_qe_price_occupancy(int steps, int qmc, int* out) {
  const PriceLaunch launch = price_launch(qmc != 0, steps);
  const void* kernel = launch.staged ? (const void*)qe_price_kernel<true>
                                     : (const void*)qe_price_kernel<false>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaFuncAttributes attr{};
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = price_blocks_per_sm(launch, &per_sm);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  const int vals[7] = {kThreads, per_sm, sms, (int)launch.smem, (int)attr.sharedSizeBytes,
                       attr.numRegs, (int)attr.localSizeBytes};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return (int)err;
}

// The price kernels' grid (K8, and K10, which must walk the same pairs per
// thread for its price to equal K8's) at `steps` steps on one stream:
// kPriceBlocks an SM, fewer only where K8's launch (its shared memory, or
// the global-table kernel past the staging limit) holds fewer.  At the
// serving steps that is the grid of the kernel before its per-stream build
// (79 registers: 3 blocks an SM), so the sums keep their bits whatever
// registers K8 now takes.  K10 stages the same bytes (80 registers), so the
// grid is one wave of both.
extern "C" int hh_qe_price_grid(int steps, int qmc, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = price_blocks_per_sm(price_launch(qmc != 0, steps), &per_sm);
  per_sm = per_sm < kPriceBlocks ? per_sm : kPriceBlocks;
  *grid = sms * (per_sm > 0 ? per_sm : 1);
  return (int)err;
}
