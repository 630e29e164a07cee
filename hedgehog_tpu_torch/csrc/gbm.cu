// Exact lognormal terminal prices for sm_90a (K13).
//
// Replaces hedgehog_tpu/ops/gbm_kernel.py gbm_exact_terminal (pallas_call at
// :47, body _gbm_kernel :27): S_T = exp(mean + std Z) per path, and
// exp(mean - std Z) for the antithetic twin, fp32.  The plain PyTorch twin
// is hedgehog_tpu_torch/ops/gbm_kernel.py; keep the two in step.
//
// What bounds it on this card: the output write, 8 bytes per antithetic
// pair, against about five special-function operations per pair (two exp,
// and half of a Box-Muller's log, square root and sincos).  The design
// gives each thread four consecutive pairs from ONE Philox call (both
// Box-Muller pairs of its four words, as the TPU kernel uses both outputs of
// its Box-Muller), so a warp writes 512 consecutive bytes of each row with
// one 16-byte store per thread where the row is 16-byte aligned
// (n_paths % 4 == 0), and scalar stores otherwise and at the ragged end.

#include "hh_device.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gbm_kernel(const float* __restrict__ params, float* __restrict__ out, long long n_paths,
           int antithetic, uint32_t seed, uint32_t device_id) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long first = 4 * g;
  if (first >= n_paths) return;
  const float mean = params[0], sd = params[1];
  const hh::U4 w = hh::philox_block((unsigned long long)g, 0u, seed, device_id);
  float z[4];
  hh::box_muller(w.x, w.y, z[0], z[1]);
  hh::box_muller(w.z, w.w, z[2], z[3]);
  float s[4], sa[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    s[k] = expf(mean + sd * z[k]);
    sa[k] = expf(mean - sd * z[k]);
  }
  float* row_a = out + n_paths;
  if ((n_paths & 3) == 0) {  // first + 4 <= n_paths, and both rows 16-byte aligned
    reinterpret_cast<float4*>(out)[g] = make_float4(s[0], s[1], s[2], s[3]);
    if (antithetic) reinterpret_cast<float4*>(row_a)[g] = make_float4(sa[0], sa[1], sa[2], sa[3]);
    return;
  }
  const int n = n_paths - first < 4 ? (int)(n_paths - first) : 4;
  for (int k = 0; k < n; ++k) {
    out[first + k] = s[k];
    if (antithetic) row_a[first + k] = sa[k];
  }
}

}  // namespace

// Terminal prices: out is (1 or 2, n_paths) float32; params (mean, std)
// float32 of log S_T.
extern "C" int hh_gbm_terminal(const float* params, float* out, long long n_paths, int antithetic,
                               unsigned seed, unsigned device_id, void* stream) {
  const long long groups = (n_paths + 3) / 4;
  const long long blocks = (groups + kThreads - 1) / kThreads;
  gbm_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(params, out, n_paths,
                                                                       antithetic, seed, device_id);
  return (int)cudaGetLastError();
}
