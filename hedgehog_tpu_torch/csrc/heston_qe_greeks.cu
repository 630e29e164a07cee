// QE mixing greek kernels for sm_90a: the fused price + 7 greeks (K10) and
// the cotangent-weighted VJP of the values kernel (K11).
//
// Replaces hedgehog_tpu/ops/heston_qe_greeks_kernel.py:
//   heston_qe_mixing_price_and_greeks (pallas_call at :445 QMC, :467 PRNG;
//                                      bodies _greeks_accum_kernel[_qmc])
//   _mixing_values_vjp                (pallas_call at :632 QMC, :654 PRNG;
//                                      bodies _greeks_weighted_kernel[_qmc])
//
// Both replay the values/price kernels' stream (heston_qe.cu, the same
// hh::mix_draws) and push forward tangents through the QE scan: per step
// the draw's two coefficients (heston_qe.cuh qe_v_coeffs) are computed once
// and applied to every direction, and J's tangent closes at the end of the
// path from (dV_T, dIV).  Spot, rho, rate (and for K11 the strike) close
// analytically from the conditional Black-Scholes partials.  The plain
// PyTorch twins are in hedgehog_tpu_torch/ops/heston_qe_greeks_kernel.py.
//
// What bounds them on this card: FP32 issue and registers.  Over the price
// kernel a step adds about three reciprocals and thirty multiply-adds, plus
// a few FMAs per direction; memory is no bound (K10 writes seven doubles per
// block, K11 reads the 4-byte cotangent of each path once).  K11 carries
// (v, IV, J, 5 dV, 5 S) for two paths per thread.  K10 walks the pairs with
// K8's grid and stride and reduces its price column with K8's tree, so its
// price equals K8's to the bit.  That grid is one resident wave of K8 (3
// blocks an SM); at 128 registers K10 held 2, so a third of its blocks ran
// after the rest on two-thirds-empty SMs (the redesigned body at 2 blocks
// there took 9% longer on an H100 than at 3, PERF.md).  K10 is built for 3
// blocks an SM (80 registers, a little spill), compiled once per stream (the other
// stream's draw state holds no registers), draws its Sobol' integers split
// at bit 5 as K9 and K12 do (hh::draw_steps: the same numbers as
// hh::mix_draws), and closes each path with hh::close_partials (the vega
// sharing Phi(cp d1)'s exponential), each field to cond_bs_partials's bits.
// K11 runs one pair a thread on a grid of ceil(n_paths / 256) blocks, so
// each block's float64 sums keep their bits; it is built as K7 is, once per
// stream (its Philox build holds no Sobol' state), draws K7's split Sobol'
// integers where the staged table and high words keep hh::kStagedBlocks
// blocks an SM (the table in global memory past that), and closes with
// K10's hh::close_partials.

#include "heston_qe.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGreekDirs = 4;   // V0, kappa, theta, sigma
constexpr int kVjpDirs = 5;     // V0, kappa, theta, sigma, T
constexpr int kGreekCols = 7;   // y, chain x 4, w, y_rho
constexpr int kVjpCols = 8;     // chain x 5, w, y_rho, y_strike
constexpr int kGreekBlocks = 3;  // K10's blocks an SM: K8's grid is one wave of both
// K11's Philox build's blocks an SM: at 3 (80 registers, no spill) it took
// 0.62 ms at 2^22 pairs on an H100 against 0.67 at 2 (110 registers) and
// 0.64 at 4 (PERF.md); its QMC builds are declared for hh::kStagedBlocks.
constexpr int kVjpBlocks = 3;

// K10's body on one stream (kQmc 1: the Sobol' table, 0: Philox), so that
// the other stream's draw state holds no registers.  The grid-stride round
// is uniform over the block, so every lane of a warp stages its round's high
// Sobol' words (hh::stage_high) before the lanes past the last pair drop
// out; a thread walks the pairs it walked one pair a thread before, in the
// same order.
template <bool kStaged, int kQmc>
__device__ __forceinline__ void greeks_body(const float* params, const float* tab,
                                            const int* sobol, double* partials,
                                            long long total_pairs, int steps, uint32_t seed,
                                            uint32_t device_id, long long point_offset,
                                            hh::MixParams& sp, float (*stab)[hh::kTanCols],
                                            double* red, int* ssob) {
  const int* staged = hh::stage_inputs<kGreekDirs, 2, hh::MixParams, kStaged>(
      params, tab, sobol, steps, sp, stab, ssob);
  const int* table = kQmc ? staged : nullptr;
  if constexpr (kQmc == 1) __builtin_assume(table != nullptr);
  // this warp's high words past the table: 2 candidates of each of the
  // 2 * steps dimensions
  uint32_t* hw = reinterpret_cast<uint32_t*>(ssob + 2 * steps * (hh::kSobolBits + 1)) +
                 (threadIdx.x >> 5) * 4 * steps;
  float acc[kGreekCols] = {};
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long base = (long long)blockIdx.x * blockDim.x; base < total_pairs; base += stride) {
    const long long g = base + threadIdx.x;
    const uint32_t p0 = (uint32_t)(point_offset + base) + (threadIdx.x & ~31u);
    if (kStaged && kQmc) hh::stage_high(table, 2 * steps, p0, hw);
    if (g >= total_pairs) continue;
    const int c = (int)(((p0 & 31u) + (threadIdx.x & 31u)) >> 5);
    hh::TanState<kGreekDirs> s, sa;
    hh::tan_init(s, sp);
    hh::tan_init(sa, sp);
    float z_odd = 0.0f;
    uint32_t w_odd = 0u;
    hh::draw_steps<kQmc == 1, kStaged>((unsigned long long)g, (uint32_t)(point_offset + g), table,
                                       hw, c, seed, device_id, 0, steps, z_odd, w_odd,
                                       [&](float z, float u) {
                                         hh::tan_step(s, z, u, sp, stab);
                                         hh::tan_step(sa, -z, 1.0f - u, sp, stab);
                                       });
    // the close shares the vega's exponential with Phi(cp d1)
    // (hh::close_partials), each field to the bit cond_bs_partials's
    const hh::BsPartials b =
        hh::close_partials<false>(hh::close_group(s.iv, s.j, sp.close), s.iv, s.j, sp.close);
    const hh::BsPartials ba =
        hh::close_partials<true>(hh::close_group(sa.iv, sa.j, sp.close), sa.iv, sa.j, sp.close);
    acc[0] += b.y + ba.y;
#pragma unroll
    for (int d = 0; d < kGreekDirs; ++d) {
      const float div = hh::div_real(s, sp, stab, d);
      const float diva = hh::div_real(sa, sp, stab, d);
      acc[1 + d] += b.y_iv * div + b.y_j * hh::dj_terms(s, sp, stab, d, div) +
                    ba.y_iv * diva + ba.y_j * hh::dj_terms(sa, sp, stab, d, diva);
    }
    acc[5] += b.w + ba.w;
    acc[6] += b.y_rho + ba.y_rho;
  }
  hh::block_sums<kThreads>(acc, red, partials);
}

// K10, one body per stream, built for kGreekBlocks blocks an SM.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads, kGreekBlocks)
qe_greeks_kernel(const float* __restrict__ params, const float* __restrict__ tab,
                 const int* __restrict__ sobol, double* __restrict__ partials,
                 long long total_pairs, int steps, uint32_t seed, uint32_t device_id,
                 long long point_offset) {
  __shared__ hh::MixParams sp;
  __shared__ float stab[kGreekDirs][hh::kTanCols];
  __shared__ double red[kThreads];
  extern __shared__ int ssob[];
  if (sobol) {
    greeks_body<kStaged, 1>(params, tab, sobol, partials, total_pairs, steps, seed, device_id,
                            point_offset, sp, stab, red, ssob);
  } else {
    greeks_body<kStaged, 0>(params, tab, sobol, partials, total_pairs, steps, seed, device_id,
                            point_offset, sp, stab, red, ssob);
  }
}

// Adds path `st`'s cotangent-weighted contributions to the eight sums.  The
// close shares the vega's exponential with Phi(cp d1) (hh::close_partials),
// each field to cond_bs_partials's bits in K11 before its redesign, whose
// compiler fused y_rho's first product into its subtraction on both paths:
// the form close_partials pins for the mirror.
__device__ __forceinline__ void weighted_sums(const hh::TanState<kVjpDirs>& st, float ct,
                                              const hh::MixParams& c,
                                              const float (*tab)[hh::kTanCols], float* acc) {
  const hh::BsPartials b =
      hh::close_partials<true>(hh::close_group(st.iv, st.j, c.close), st.iv, st.j, c.close);
#pragma unroll
  for (int d = 0; d < kVjpDirs; ++d) {
    const float div = hh::div_real(st, c, tab, d);
    acc[d] += ct * (b.y_iv * div + b.y_j * hh::dj_terms(st, c, tab, d, div));
  }
  acc[5] += ct * b.w;
  acc[6] += ct * b.y_rho;
  acc[7] += ct * (-c.close.cp * b.phi2);
}

// The block's eight float64 sums by hh::block_sums' tree (at each level h
// the sum of thread t + h's subtree is added to thread t's, t < h), all
// eight columns at once: the levels 128 to 32 through shared memory (the
// upper half's sums), 16 to 1 in warp 0 by shuffles.  The same additions
// in the same order, so the same bits, with 5 barriers where block_sums
// takes 10 a column: at one pair a thread the tree was a sixth of K11's
// time on an H100 (PERF.md).
__device__ __forceinline__ void vjp_block_sums(const float (&acc)[kVjpCols],
                                               double (*red)[kThreads / 2], double* partials) {
  const int t = threadIdx.x;
  double v[kVjpCols];
#pragma unroll
  for (int k = 0; k < kVjpCols; ++k) v[k] = (double)acc[k];
#pragma unroll
  for (int h = kThreads / 2; h >= 32; h >>= 1) {
    if (t >= h && t < 2 * h) {
#pragma unroll
      for (int k = 0; k < kVjpCols; ++k) red[k][t - h] = v[k];
    }
    __syncthreads();
    if (t < h) {
#pragma unroll
      for (int k = 0; k < kVjpCols; ++k) v[k] += red[k][t];
    }
    if (h > 32) __syncthreads();  // the next level rewrites what this one read
  }
  if (t < 32) {
#pragma unroll
    for (int h = 16; h > 0; h >>= 1) {
#pragma unroll
      for (int k = 0; k < kVjpCols; ++k) v[k] += __shfl_down_sync(0xffffffffu, v[k], h);
    }
    if (t == 0) {
#pragma unroll
      for (int k = 0; k < kVjpCols; ++k) partials[(long long)k * gridDim.x + blockIdx.x] = v[k];
    }
  }
}

// K11 on one stream (kQmc 1: the Sobol' table, 0: Philox), one pair a
// thread: thread i walks pair i (Sobol' point point_offset + i) with its
// tangents and adds its cotangent-weighted sums, ct[i] and, under
// antithetic pairing, ct[n_paths + i] for the antithetic path; the block
// sums them in float64 (vjp_block_sums).  Staged under QMC, it draws K7's
// split Sobol' integers (hh::draw_steps, the warp's high words staged by
// hh::stage_high), so every lane of the last, ragged warp stages before the
// lanes past n_paths drop out; the global-table build (kStaged false) forms
// the same integers through sobol_bits.  The pairing stays a run-time test,
// as in K7.
template <bool kStaged, int kQmc>
__global__ void __launch_bounds__(kThreads, kQmc ? hh::kStagedBlocks : kVjpBlocks)
qe_vjp_kernel(const float* __restrict__ params, const float* __restrict__ tab,
              const int* __restrict__ sobol, const float* __restrict__ ct,
              double* __restrict__ partials, long long n_paths, int steps, int antithetic,
              uint32_t seed, uint32_t device_id, long long point_offset) {
  __shared__ hh::MixParams sp;
  __shared__ float stab[kVjpDirs][hh::kTanCols];
  __shared__ double red[kVjpCols][kThreads / 2];
  extern __shared__ int ssob[];
  const int* staged = hh::stage_inputs<kVjpDirs, 2, hh::MixParams, kStaged>(params, tab, sobol,
                                                                           steps, sp, stab, ssob);
  const int* table = kQmc ? staged : nullptr;
  if constexpr (kQmc == 1) __builtin_assume(table != nullptr);
  const long long base = (long long)blockIdx.x * blockDim.x;
  const long long i = base + threadIdx.x;
  const uint32_t p0 = (uint32_t)(point_offset + base) + (threadIdx.x & ~31u);
  uint32_t* hw = hh::warp_high_words(ssob, 2 * steps);
  if (kStaged && kQmc) hh::stage_high(table, 2 * steps, p0, hw);
  float acc[kVjpCols] = {};
  if (i < n_paths) {
    const int c = (int)(((p0 & 31u) + (threadIdx.x & 31u)) >> 5);
    hh::TanState<kVjpDirs> s, sa;
    hh::tan_init(s, sp);
    hh::tan_init(sa, sp);
    float z_odd = 0.0f;
    uint32_t w_odd = 0u;
    hh::draw_steps<kQmc == 1, kStaged>((unsigned long long)i, (uint32_t)(point_offset + i), table,
                                       hw, c, seed, device_id, 0, steps, z_odd, w_odd,
                                       [&](float z, float u) {
                                         hh::tan_step(s, z, u, sp, stab);
                                         if (antithetic) hh::tan_step(sa, -z, 1.0f - u, sp, stab);
                                       });
    weighted_sums(s, ct[i], sp, stab, acc);
    if (antithetic) weighted_sums(sa, ct[n_paths + i], sp, stab, acc);
  }
  vjp_block_sums(acc, red, partials);
}

// K10's staged dynamic shared memory: the table, then each warp's high words.
size_t greeks_smem(bool qmc, int steps) {
  return qmc ? sizeof(int) * 2 * steps * (hh::kSobolBits + 1) +
                   sizeof(uint32_t) * (kThreads / 32) * 4 * steps
             : 0;
}

}  // namespace

// Price and greek sums over the pairs [0, total_pairs): partials is
// (7, grid) float64, column-major by sum.  The Sobol' table is staged in
// shared memory where it fits a block, else read from global memory.
extern "C" int hh_qe_greeks(const float* params, const float* tab, const int* sobol,
                            double* partials, int grid, long long total_pairs, int steps,
                            unsigned seed, unsigned device_id, long long point_offset,
                            void* stream) {
  const size_t smem = greeks_smem(sobol != nullptr, steps);
  if (smem <= hh::smem_room(qe_greeks_kernel<true>)) {
    const cudaError_t err = hh::allow_dynamic_smem(qe_greeks_kernel<true>, smem);
    if (err != cudaSuccess) return (int)err;
    qe_greeks_kernel<true><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        params, tab, sobol, partials, total_pairs, steps, seed, device_id, point_offset);
  } else {
    qe_greeks_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        params, tab, sobol, partials, total_pairs, steps, seed, device_id, point_offset);
  }
  return (int)cudaGetLastError();
}

// Cotangent-weighted sums over the paths: ct is (1 or 2, n_paths) float32,
// partials (8, ceil(n_paths / 256)) float64.  Under QMC the staged build
// (the table and each warp's high words in dynamic shared memory, the split
// draw) where it keeps hh::kStagedBlocks blocks an SM, else the build that
// reads the table from global memory.
extern "C" int hh_qe_values_vjp(const float* params, const float* tab, const int* sobol,
                                const float* ct, double* partials, long long n_paths, int steps,
                                int antithetic, unsigned seed, unsigned device_id,
                                long long point_offset, void* stream) {
  const unsigned blocks = (unsigned)((n_paths + kThreads - 1) / kThreads);
  const auto run = [&](auto kernel, size_t smem) {
    kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(params, tab, sobol, ct, partials,
                                                             n_paths, steps, antithetic, seed,
                                                             device_id, point_offset);
    return (int)cudaGetLastError();
  };
  if (!sobol) return run(qe_vjp_kernel<false, 0>, 0);
  const size_t smem = hh::split_smem(2 * steps, kThreads);
  bool staged = false;
  const cudaError_t err = hh::split_fits(qe_vjp_kernel<true, 1>, kThreads, smem, &staged);
  if (err != cudaSuccess) return (int)err;
  return staged ? run(qe_vjp_kernel<true, 1>, smem) : run(qe_vjp_kernel<false, 1>, 0);
}

// K10's occupancy on the current device at `steps` steps, QMC (its table and
// high words staged where they fit a block) or Philox: out = (threads a
// block, resident blocks per SM, SMs, dynamic shared bytes, static shared
// bytes, registers a thread, local (spill) bytes a thread).
extern "C" int hh_qe_greeks_occupancy(int steps, int qmc, int* out) {
  size_t smem = greeks_smem(qmc != 0, steps);
  const void* kernel = (const void*)qe_greeks_kernel<true>;
  if (smem > hh::smem_room(qe_greeks_kernel<true>)) {
    kernel = (const void*)qe_greeks_kernel<false>;
    smem = 0;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaFuncAttributes attr{};
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && kernel == (const void*)qe_greeks_kernel<true>) {
    err = hh::allow_dynamic_smem(qe_greeks_kernel<true>, smem);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  }
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  const int vals[7] = {kThreads, per_sm, sms, (int)smem, (int)attr.sharedSizeBytes, attr.numRegs,
                       (int)attr.localSizeBytes};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return (int)err;
}
