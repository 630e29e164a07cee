// Full-truncation log-Euler Heston terminal prices for sm_90a (K1).
//
// Replaces hedgehog_tpu/ops/heston_kernel.py heston_euler_terminal
// (pallas_call at :180, body _heston_kernel :75).  Per step and path:
//
//   logS += (r - V+/2) dt + sqrt(V+ dt) Z1
//   V    += kappa (theta - V+) dt + sigma sqrt(V+ dt) (rho Z1 + rho_bar Z2)
//
// with V+ = max(V, 0) and (Z1, Z2) one Box-Muller pair.  The plain PyTorch
// twin is hedgehog_tpu_torch/ops/heston_kernel.py; keep the two in step.
//
// What bounds it on this card: instruction issue (per step one log, one
// sincos and three square roots for the pair, plus half a Philox call; 64
// warps an SM at 36 registers), not memory: 4 bytes per path leave the card
// once, at the end.  The design keeps one antithetic pair per thread (more
// threads a pair slow an issue-bound chain), both states (x, v, xa, va) in
// registers across all steps, shares one Box-Muller pair between the path
// and its twin (negated normals), and spends no instruction the bits do not
// need: one loop body per Philox block (two steps, no per-step parity
// test; an odd step count ends with the block's first half), the pairing
// fixed at compile time, and sqrt(V+ dt) through hh::sqrt_nonneg, sqrtf's
// bits without the branch full truncation's zero takes.  Writes are
// coalesced: neighbouring threads write neighbouring paths of each (g, n)
// row.

#include "hh_device.cuh"

namespace {

constexpr int kThreads = 256;

struct EulerConst {
  float dt, drift_r, kappa, theta, sigma, rho, rho_bar;
};

__device__ __forceinline__ void euler_advance(float& x, float& v, float z1, float z2,
                                              const EulerConst& c) {
  const float v_plus = fmaxf(v, 0.0f);
  const float sqrt_vdt = hh::sqrt_nonneg(v_plus * c.dt);
  const float x2 = x + (c.drift_r - 0.5f * v_plus * c.dt) + sqrt_vdt * z1;
  const float v2 = v + c.kappa * (c.theta - v_plus) * c.dt +
                   c.sigma * sqrt_vdt * (c.rho * z1 + c.rho_bar * z2);
  x = x2;
  v = v2;
}

// One step of the path and, under kAnti, of its twin from Philox words
// (b0, b1).
template <bool kAnti>
__device__ __forceinline__ void euler_step(float& x, float& v, float& xa, float& va, uint32_t b0,
                                           uint32_t b1, const EulerConst& c) {
  float z1, z2;
  hh::box_muller(b0, b1, z1, z2);
  euler_advance(x, v, z1, z2, c);
  if constexpr (kAnti) euler_advance(xa, va, -z1, -z2, c);
}

// params: (log_s0, v0, r, kappa, theta, sigma, rho, dt) float32.
template <bool kAnti>
__global__ void __launch_bounds__(kThreads)
heston_euler_kernel(const float* __restrict__ params, float* __restrict__ out, long long n_paths,
                    int steps, uint32_t seed, uint32_t device_id) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_paths) return;
  const float rho = params[6], dt = params[7];
  const EulerConst c{dt, params[2] * dt, params[3], params[4], params[5], rho,
                     sqrtf(fmaxf(1.0f - rho * rho, 0.0f))};
  float x = params[0], v = params[1];
  float xa = x, va = v;
  // Philox block k: words 0, 1 drive step 2k, words 2, 3 step 2k + 1
  for (int k = 0; k < steps / 2; ++k) {
    const hh::U4 w = hh::philox_block((unsigned long long)i, (uint32_t)k, seed, device_id);
    euler_step<kAnti>(x, v, xa, va, w.x, w.y, c);
    euler_step<kAnti>(x, v, xa, va, w.z, w.w, c);
  }
  if (steps & 1) {
    const hh::U4 w =
        hh::philox_block((unsigned long long)i, (uint32_t)(steps / 2), seed, device_id);
    euler_step<kAnti>(x, v, xa, va, w.x, w.y, c);
  }
  out[i] = expf(x);
  if constexpr (kAnti) out[n_paths + i] = expf(xa);
}

}  // namespace

// Terminal prices: out is (1 or 2, n_paths) float32.
extern "C" int hh_heston_euler_terminal(const float* params, float* out, long long n_paths,
                                        int steps, int antithetic, unsigned seed,
                                        unsigned device_id, void* stream) {
  const long long blocks = (n_paths + kThreads - 1) / kThreads;
  if (antithetic) {
    heston_euler_kernel<true><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        params, out, n_paths, steps, seed, device_id);
  } else {
    heston_euler_kernel<false><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        params, out, n_paths, steps, seed, device_id);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* hh_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
