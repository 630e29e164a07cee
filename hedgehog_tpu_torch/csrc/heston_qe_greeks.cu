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

#include "heston_qe.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGreekDirs = 4;   // V0, kappa, theta, sigma
constexpr int kVjpDirs = 5;     // V0, kappa, theta, sigma, T
constexpr int kGreekCols = 7;   // y, chain x 4, w, y_rho
constexpr int kVjpCols = 8;     // chain x 5, w, y_rho, y_strike
constexpr int kGreekBlocks = 3;  // K10's blocks an SM: K8's grid is one wave of both

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
    hh::draw_steps<kStaged>((unsigned long long)g, (uint32_t)(point_offset + g), table, hw, c,
                            seed, device_id, 0, steps, z_odd, w_odd, [&](float z, float u) {
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

// Adds path `st`'s cotangent-weighted contributions to the eight sums.
__device__ __forceinline__ void weighted_sums(const hh::TanState<kVjpDirs>& st, float ct,
                                              const hh::MixParams& c,
                                              const float (*tab)[hh::kTanCols], float* acc) {
  const hh::BsPartials b = hh::cond_bs_partials(st.iv, st.j, c.close);
#pragma unroll
  for (int d = 0; d < kVjpDirs; ++d) {
    const float div = hh::div_real(st, c, tab, d);
    acc[d] += ct * (b.y_iv * div + b.y_j * hh::dj_terms(st, c, tab, d, div));
  }
  acc[5] += ct * b.w;
  acc[6] += ct * b.y_rho;
  acc[7] += ct * (-c.close.cp * b.phi2);
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
qe_vjp_kernel(const float* __restrict__ params, const float* __restrict__ tab,
              const int* __restrict__ sobol, const float* __restrict__ ct,
              double* __restrict__ partials, long long n_paths, int steps, int antithetic,
              uint32_t seed, uint32_t device_id, long long point_offset) {
  __shared__ hh::MixParams sp;
  __shared__ float stab[kVjpDirs][hh::kTanCols];
  __shared__ double red[kThreads];
  extern __shared__ int ssob[];
  const int* table = hh::stage_inputs<kVjpDirs, 2, hh::MixParams, kStaged>(params, tab, sobol,
                                                                          steps, sp, stab, ssob);
  float acc[kVjpCols] = {};
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_paths) {
    hh::TanState<kVjpDirs> s, sa;
    hh::tan_init(s, sp);
    hh::tan_init(sa, sp);
    hh::mix_draws((unsigned long long)i, table, steps, seed, device_id, point_offset,
                  [&](float z, float u) {
                    hh::tan_step(s, z, u, sp, stab);
                    if (antithetic) hh::tan_step(sa, -z, 1.0f - u, sp, stab);
                  });
    weighted_sums(s, ct[i], sp, stab, acc);
    if (antithetic) weighted_sums(sa, ct[n_paths + i], sp, stab, acc);
  }
  hh::block_sums<kThreads>(acc, red, partials);
}

size_t sobol_smem(const int* sobol, int steps) {
  return sobol ? sizeof(int) * 2 * steps * (hh::kSobolBits + 1) : 0;
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
// partials (8, ceil(n_paths / 256)) float64.
extern "C" int hh_qe_values_vjp(const float* params, const float* tab, const int* sobol,
                                const float* ct, double* partials, long long n_paths, int steps,
                                int antithetic, unsigned seed, unsigned device_id,
                                long long point_offset, void* stream) {
  const long long blocks = (n_paths + kThreads - 1) / kThreads;
  const size_t smem = sobol_smem(sobol, steps);
  if (smem <= hh::smem_room(qe_vjp_kernel<true>)) {
    const cudaError_t err = hh::allow_dynamic_smem(qe_vjp_kernel<true>, smem);
    if (err != cudaSuccess) return (int)err;
    qe_vjp_kernel<true><<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
        params, tab, sobol, ct, partials, n_paths, steps, antithetic, seed, device_id,
        point_offset);
  } else {
    qe_vjp_kernel<false><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        params, tab, sobol, ct, partials, n_paths, steps, antithetic, seed, device_id,
        point_offset);
  }
  return (int)cudaGetLastError();
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
