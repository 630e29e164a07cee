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
// price equals K8's to the bit.

#include "heston_qe.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGreekDirs = 4;   // V0, kappa, theta, sigma
constexpr int kVjpDirs = 5;     // V0, kappa, theta, sigma, T
constexpr int kGreekCols = 7;   // y, chain x 4, w, y_rho
constexpr int kVjpCols = 8;     // chain x 5, w, y_rho, y_strike

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
qe_greeks_kernel(const float* __restrict__ params, const float* __restrict__ tab,
                 const int* __restrict__ sobol, double* __restrict__ partials,
                 long long total_pairs, int steps, uint32_t seed, uint32_t device_id,
                 long long point_offset) {
  __shared__ hh::MixParams sp;
  __shared__ float stab[kGreekDirs][hh::kTanCols];
  __shared__ double red[kThreads];
  extern __shared__ int ssob[];
  const int* table = hh::stage_inputs<kGreekDirs, 2, hh::MixParams, kStaged>(params, tab, sobol,
                                                                            steps, sp, stab, ssob);
  float acc[kGreekCols] = {};
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < total_pairs;
       g += stride) {
    hh::TanState<kGreekDirs> s, sa;
    hh::tan_init(s, sp);
    hh::tan_init(sa, sp);
    hh::mix_draws((unsigned long long)g, table, steps, seed, device_id, point_offset,
                  [&](float z, float u) {
                    hh::tan_step(s, z, u, sp, stab);
                    hh::tan_step(sa, -z, 1.0f - u, sp, stab);
                  });
    const hh::BsPartials b = hh::cond_bs_partials(s.iv, s.j, sp.close);
    const hh::BsPartials ba = hh::cond_bs_partials(sa.iv, sa.j, sp.close);
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

}  // namespace

// Price and greek sums over the pairs [0, total_pairs): partials is
// (7, grid) float64, column-major by sum.  The Sobol' table is staged in
// shared memory where it fits a block, else read from global memory.
extern "C" int hh_qe_greeks(const float* params, const float* tab, const int* sobol,
                            double* partials, int grid, long long total_pairs, int steps,
                            unsigned seed, unsigned device_id, long long point_offset,
                            void* stream) {
  const size_t smem = sobol_smem(sobol, steps);
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
