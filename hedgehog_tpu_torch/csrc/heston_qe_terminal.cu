// QE-M terminal-sampler kernels for sm_90a: terminal prices (K5) and the
// accumulating serving call price (K6).
//
// Replaces hedgehog_tpu/ops/heston_qe_kernel.py:
//   heston_qe_terminal    (pallas_call at :400 QMC, :422 PRNG;
//                          bodies _qe_kernel_qmc :266, _qe_kernel :220)
//   heston_qe_call_price  (pallas_call at :498; body _qe_price_kernel :436)
//
// Per step a path draws two normals and a uniform, moves V by the QE scheme
// and log S by the martingale-corrected QE-M update (hh_device.cuh
// qem_advance, the TPU's _qe_advance).  K5 writes S_T = exp(log S_T); K6
// sums the call payoffs of both paths of every pair.  The plain PyTorch
// twins are in hedgehog_tpu_torch/ops/heston_qe_kernel.py; keep the two in
// step.
//
// What bounds it on this card: FP32 and special-function issue, not memory.
// Per step and path: two or three polished reciprocals, a square root and
// one or two logs for the QE draw and the martingale correction, the
// square root of the log-price variance, and for the stream a Philox call
// and a Box-Muller pair (or three Sobol' integers, each a staged high word
// XOR the point's five low rows, and two inverse normals).  K5 is built
// once per stream, so neither build carries the other's state.  K5 writes
// 4 bytes per path once, K6 one double per block.  The design keeps
// one antithetic pair per thread with (log S, V) of both paths in registers,
// shares the pair's draws (normals negated, u mirrored), evaluates only the
// QE branch and the martingale-correction branch a lane takes (the TPU
// kernel computes both and selects), and writes K5's rows coalesced:
// neighbouring threads write neighbouring paths.  K6 runs one resident wave
// of blocks that each walk a fixed stride of pairs, so a thread sums ~1000
// pairs at the serving shape; that running sum is float64 (one DADD per
// pair, against a few hundred fp32 operations), because an fp32 running sum
// of ~1000 payoffs of up to ~100 each rounds with a bias of order 1e-7 of
// the price (K8's fp32 sum drifted 1.27e-7 from its twin at 2^27 pairs).
// The block tree and the per-block partials are heston_qe.cuh block_sums.
// A warp issues about one instruction a clock here, so what K6 saves is
// instructions (hh_device.cuh rcp_normal and sqrt_normal, shared with K5).
// Two threads a pair (the exact price kernel's layout) ran 1.09x slower on
// an H100: the shuffles and selects it adds cost more than the latency its
// 64 warps an SM hide (PERF.md).

#include "heston_qe.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPriceBlocks = 5;  // K6's blocks an SM (48 registers at most): its grid
constexpr int kTerminalQmcBlocks = 4;  // K5's blocks an SM under QMC (PERF.md §6)

struct QemPriceParams {
  hh::QemParams c;
  float strike;
};
static_assert(sizeof(QemPriceParams) == 15 * sizeof(float), "QE-M price parameter layout");

// Terminal log-prices (x, x_a) of global pair `pair`.
__device__ __forceinline__ void qem_pair(unsigned long long pair, const hh::QemParams& c,
                                         const int* sobol, int steps, bool antithetic, bool mcorr,
                                         uint32_t seed, uint32_t device_id, long long point_offset,
                                         float& x, float& xa) {
  float v = c.v0, va = c.v0;
  x = c.log_s0;
  xa = c.log_s0;
  hh::qem_draws(pair, sobol, steps, seed, device_id, point_offset,
                [&](float z_v, float z_x, float u) {
                  hh::qem_advance(x, v, z_v, z_x, u, c, mcorr);
                  if (antithetic) hh::qem_advance(xa, va, -z_v, -z_x, 1.0f - u, c, mcorr);
                });
}

// K5 on one stream (kQmc 1: the Sobol' table, 0: Philox), one pair a
// thread: thread i walks pair i (Sobol' point point_offset + i) and writes
// S_T to out[i] and, under antithetic pairing, the antithetic path's to
// out[n_paths + i].  The Philox build is K6's walk at K6's kPriceBlocks
// blocks an SM.  Staged under QMC, each Sobol' integer is the warp's high
// word XOR sobol_low (heston_qe.cuh qem_split_steps, the high words staged
// by hh::stage_high over 3 * steps dimensions), so every lane of the last,
// ragged warp stages before the lanes past n_paths drop out; the
// global-table build (kStaged false) forms the same integers through
// sobol_bits.  The pairing and the martingale correction stay run-time
// tests: a build per pairing saved 13 of 853 instructions of the staged
// QMC step loop, none of the Philox one, and moved no time by 2% (PERF.md
// §6).
template <bool kStaged, int kQmc>
__global__ void __launch_bounds__(kThreads, kQmc ? kTerminalQmcBlocks : kPriceBlocks)
qem_terminal_kernel(const float* __restrict__ params, const int* __restrict__ sobol,
                    float* __restrict__ out, long long n_paths, int steps, int antithetic,
                    int mcorr, uint32_t seed, uint32_t device_id, long long point_offset) {
  __shared__ hh::QemParams sp;
  extern __shared__ int ssob[];
  const int* staged =
      hh::stage_inputs<0, 3, hh::QemParams, kStaged>(params, nullptr, sobol, steps, sp, nullptr, ssob);
  const int* table = kQmc ? staged : nullptr;
  if constexpr (kQmc == 1) __builtin_assume(table != nullptr);
  const long long base = (long long)blockIdx.x * blockDim.x;
  const long long i = base + threadIdx.x;
  const uint32_t p0 = (uint32_t)(point_offset + base) + (threadIdx.x & ~31u);
  uint32_t* hw = hh::warp_high_words(ssob, 3 * steps);
  if (kStaged && kQmc) hh::stage_high(table, 3 * steps, p0, hw);
  if (i >= n_paths) return;
  const int c = (int)(((p0 & 31u) + (threadIdx.x & 31u)) >> 5);
  float v = sp.v0, va = sp.v0, x = sp.log_s0, xa = sp.log_s0;
  const auto step = [&](float z_v, float z_x, float u) {
    hh::qem_advance(x, v, z_v, z_x, u, sp, mcorr != 0);
    if (antithetic) hh::qem_advance(xa, va, -z_v, -z_x, 1.0f - u, sp, mcorr != 0);
  };
  if constexpr (kStaged && kQmc == 1) {
    hh::qem_split_steps((uint32_t)(point_offset + i), table, hw, c, steps, step);
  } else {
    hh::qem_draws((unsigned long long)i, table, steps, seed, device_id, point_offset, step);
  }
  out[i] = expf(x);
  if (antithetic) out[n_paths + i] = expf(xa);
}

// K6: one pair a thread on K5's pairs and stream, built for kPriceBlocks
// blocks an SM, its grid one resident wave of them (660 blocks on an H100;
// the kernel before held 4 an SM at 62 registers, and at 4 this one runs 2%
// slower).
__global__ void __launch_bounds__(kThreads, kPriceBlocks)
qem_price_kernel(const float* __restrict__ params, double* __restrict__ partials,
                 long long total_pairs, int steps, uint32_t seed, uint32_t device_id) {
  __shared__ QemPriceParams sp;
  __shared__ double red[kThreads];
  hh::stage_inputs<0, 3>(params, nullptr, nullptr, steps, sp, nullptr, nullptr);
  double acc[1] = {0.0};
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < total_pairs;
       g += stride) {
    float x, xa;
    qem_pair((unsigned long long)g, sp.c, nullptr, steps, true, true, seed, device_id, 0, x, xa);
    acc[0] += (double)(fmaxf(expf(x) - sp.strike, 0.0f) + fmaxf(expf(xa) - sp.strike, 0.0f));
  }
  hh::block_sums<kThreads>(acc, red, partials);
}

}  // namespace

// Terminal prices: out is (1 or 2, n_paths) float32; params (14,) float32;
// sobol the (3*steps, 31) table or null (Philox).  Under QMC the staged
// build (the table and each warp's high words in dynamic shared memory, the
// split draw) where it keeps hh::kStagedBlocks blocks an SM, else the build
// that reads the table from global memory.
extern "C" int hh_qem_terminal(const float* params, const int* sobol, float* out,
                               long long n_paths, int steps, int antithetic, int mcorr,
                               unsigned seed, unsigned device_id, long long point_offset,
                               void* stream) {
  const unsigned blocks = (unsigned)((n_paths + kThreads - 1) / kThreads);
  const auto run = [&](auto kernel, size_t smem) {
    kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
        params, sobol, out, n_paths, steps, antithetic, mcorr, seed, device_id, point_offset);
    return (int)cudaGetLastError();
  };
  if (!sobol) return run(qem_terminal_kernel<false, 0>, 0);
  const size_t smem = hh::split_smem(3 * steps, kThreads);
  bool staged = false;
  const cudaError_t err = hh::split_fits(qem_terminal_kernel<true, 1>, kThreads, smem, &staged);
  if (err != cudaSuccess) return (int)err;
  return staged ? run(qem_terminal_kernel<true, 1>, smem) : run(qem_terminal_kernel<false, 1>, 0);
}

// Sums of the pairs' two call payoffs: partials is (grid,) float64, one per
// block; params (15,) float32, the strike last.
extern "C" int hh_qem_price(const float* params, double* partials, int grid,
                            long long total_pairs, int steps, unsigned seed, unsigned device_id,
                            void* stream) {
  qem_price_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(params, partials, total_pairs,
                                                                steps, seed, device_id);
  return (int)cudaGetLastError();
}

// K6's occupancy on the current device: out = (threads a block, resident
// blocks per SM, SMs, dynamic shared bytes, static shared bytes, registers a
// thread, local bytes a thread: its stack, sincosf's reduction of a huge
// argument, which Box-Muller's angle never needs).
extern "C" int hh_qem_price_occupancy(int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaFuncAttributes attr{};
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, qem_price_kernel, kThreads, 0);
  }
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, qem_price_kernel);
  const int vals[7] = {kThreads, per_sm, sms, 0, (int)attr.sharedSizeBytes, attr.numRegs,
                       (int)attr.localSizeBytes};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return (int)err;
}

// K6's grid: one resident wave of qem_price_kernel on the current device.
extern "C" int hh_qem_price_grid(int* grid) {
  int occ[7];
  const int err = hh_qem_price_occupancy(occ);
  *grid = occ[2] * (occ[1] > 0 ? occ[1] : 1);
  return err;
}
