// Exact-transition Heston mixing kernels for sm_90a: per-path values (K2)
// and the accumulating serving price (K3).
//
// Replaces hedgehog_tpu/ops/heston_exact_kernel.py:
//   heston_exact_mixing_values          (pallas_call at :406 QMC, :428 PRNG;
//                                        bodies _exact_values_kernel[_qmc])
//   heston_exact_mixing_vanilla_price   (pallas_call at :490 QMC, :511 PRNG;
//                                        bodies _exact_price_kernel[_qmc])
//
// Per segment a path draws the exact CIR transition (Poisson count by CDF
// inversion, then a boosted corrected-saddlepoint gamma quantile), the exact
// conditional moments of the integrated variance through the Bessel ratio,
// and a moment-matched gamma integrated variance; the path closes with the
// conditional Black-Scholes formula.  The plain PyTorch twin is
// hedgehog_tpu_torch/ops/heston_exact_kernel.py; keep the two in step.
//
// What bounds it on this card: issue rate of FP32 and of the special
// function unit (per segment ~4 lambda(eta) solves with 2-3 Newton trips of
// a log and a reciprocal each, 16 continued-fraction reciprocals, exp/log
// pairs of the Poisson and boost draws) and registers.  Memory is no
// bound: K2 writes 4 bytes per path, K3 nothing per path (one double per
// block).  The design keeps all state in registers, evaluates only the
// branch a lane takes (the TPU kernel computes both sides of every select),
// leaves the data-dependent Poisson loop as soon as the count is settled
// (the count cannot change once u <= cdf), and for K3 runs one resident
// wave of blocks that each walk a fixed stride of pairs, so no path data
// touches memory.  The segment is a long dependent chain, so K2 and K3 (as
// K4 below) run two threads a pair, one antithetic group each, the draws
// shared by shuffles (exact_group): twice the chains in flight of one pair
// a thread at 98-127 registers (2 blocks of 256 an SM), with 3 blocks of
// 512 an SM at 40 registers.  A thread walks the segment in one pair a
// thread's operations and order, and K3 sums each pair in that kernel's
// order, so each pair's values and, at one grid, the sums keep their bits.
// K2 without antithetic pairing keeps one path a thread (no mirror to share
// the draws with).
// Parameters and the Sobol' table sit in shared memory; a table too large
// for a block's shared memory (227 KB on an H100: past about 460 segments)
// is read from global memory instead, by a second instantiation of each
// kernel (kStaged false): the same integers, so the same draws.  K2 and K3
// under antithetic pairing stage each warp's high words beside the table
// (the split draw) only where that leaves 2 blocks an SM (up to ~113
// segments on an H100) and read the table from global memory past that
// (pair_launch).  K2 and K3 once refused QMC runs
// past 16 segments: nothing in the kernels needed it (no unrolled loop over
// segments, no register that grows with them; the table then took 7.9 KB),
// only the price grid (hh_exact_price_grid) is taken at a fixed 16-row
// table so that it depends on neither the stream nor the segments.

#include "hh_device.cuh"

namespace {

// Field order is _P_NAMES of heston_exact_kernel.py; the first seven are
// hh::CloseParams.
struct ExactParams {
  hh::CloseParams close;
  float v0, lam_fac, d_half, two_cfac;
  float nu, nu2, z_fac, an1, an2, an3, ad1, ad2, ad3;
  float l1c, l1x, l2c, l2x, q, p_c, q2, m1f, s2f, inv_kappa;
  float c_j, k_over_sigma, inv_sigma;
};
constexpr int kNumParams = 33;
static_assert(sizeof(ExactParams) == kNumParams * sizeof(float), "parameter layout");

constexpr int kCfIters = 16;
constexpr float kCfSwitch = 24.0f;
constexpr int kGqNewton = 3;
constexpr int kGqNewtonE1 = 2;
constexpr int kMaxKmax = 65;  // poisson_kmax never returns more
constexpr int kThreads = 256;                      // K2 without antithetic pairing
constexpr int kPairThreads = 512;                  // K2 and K3: two threads a pair
constexpr int kRoundPairs = kPairThreads / 2;      // pairs a round of a block
constexpr int kPairBlocks = 3;                     // their blocks an SM (40 registers)
// The fewest blocks an SM at which K2 and K3 stage the Sobol' table: at 2
// the staged split draw beat the table in global memory at 3 (100
// segments, 1.09x), at 1 it lost (160 segments, 1.15x; PERF.md §6).
constexpr int kStagedBlocks = 2;

// 1/k rounded from double, as the TPU kernel's Python constant (1.0 / k).
__constant__ float kInvK[kMaxKmax + 1] = {
    0.0f, (float)(1.0 / 1), (float)(1.0 / 2), (float)(1.0 / 3), (float)(1.0 / 4),
    (float)(1.0 / 5), (float)(1.0 / 6), (float)(1.0 / 7), (float)(1.0 / 8),
    (float)(1.0 / 9), (float)(1.0 / 10), (float)(1.0 / 11), (float)(1.0 / 12),
    (float)(1.0 / 13), (float)(1.0 / 14), (float)(1.0 / 15), (float)(1.0 / 16),
    (float)(1.0 / 17), (float)(1.0 / 18), (float)(1.0 / 19), (float)(1.0 / 20),
    (float)(1.0 / 21), (float)(1.0 / 22), (float)(1.0 / 23), (float)(1.0 / 24),
    (float)(1.0 / 25), (float)(1.0 / 26), (float)(1.0 / 27), (float)(1.0 / 28),
    (float)(1.0 / 29), (float)(1.0 / 30), (float)(1.0 / 31), (float)(1.0 / 32),
    (float)(1.0 / 33), (float)(1.0 / 34), (float)(1.0 / 35), (float)(1.0 / 36),
    (float)(1.0 / 37), (float)(1.0 / 38), (float)(1.0 / 39), (float)(1.0 / 40),
    (float)(1.0 / 41), (float)(1.0 / 42), (float)(1.0 / 43), (float)(1.0 / 44),
    (float)(1.0 / 45), (float)(1.0 / 46), (float)(1.0 / 47), (float)(1.0 / 48),
    (float)(1.0 / 49), (float)(1.0 / 50), (float)(1.0 / 51), (float)(1.0 / 52),
    (float)(1.0 / 53), (float)(1.0 / 54), (float)(1.0 / 55), (float)(1.0 / 56),
    (float)(1.0 / 57), (float)(1.0 / 58), (float)(1.0 / 59), (float)(1.0 / 60),
    (float)(1.0 / 61), (float)(1.0 / 62), (float)(1.0 / 63), (float)(1.0 / 64),
    (float)(1.0 / 65),
};

// Corrected saddlepoint fit (models/heston_exact.py GQ_P2 / GQ_P3).
__constant__ float kGqP2[15] = {
    (float)-1.76222600e-02, (float)-2.93765073e-02, (float)2.14155241e-01,
    (float)-2.72541844e-01, (float)-8.34309734e-01, (float)1.90338824e+00,
    (float)1.60407347e+00, (float)-5.14361722e+00, (float)-1.51201354e+00,
    (float)7.20404411e+00, (float)3.65575150e-01, (float)-5.21675853e+00,
    (float)4.56357262e-01, (float)1.55081017e+00, (float)-2.78395827e-01};
__constant__ float kGqP3[11] = {
    (float)5.39443911e-03, (float)-1.14541171e-02, (float)-3.45087047e-02,
    (float)1.30529962e-01, (float)4.88113067e-02, (float)-4.25758711e-01,
    (float)6.65709220e-02, (float)5.57799053e-01, (float)-1.97560263e-01,
    (float)-2.55404255e-01, (float)1.14194771e-01};

// I_{nu+1}(z)/I_nu(z): backward Perron continued fraction below z = 24,
// the 4-term asymptotic ratio above.
__device__ __forceinline__ float bessel_ratio(float z, const ExactParams& c) {
  if (z < kCfSwitch) {
    float r = 0.0f;
#pragma unroll
    for (int m = kCfIters; m >= 1; --m) r = z * hh::rcp(2.0f * (c.nu + (float)m) + z * r);
    return r;
  }
  const float it = hh::rcp(8.0f * z);
  const float num = 1.0f + it * (-c.an1 + it * (c.an2 - it * c.an3));
  const float den = 1.0f + it * (-c.ad1 + it * (c.ad2 - it * c.ad3));
  return num * hh::rcp(den);
}

// lambda from lambda - 1 - ln(lambda) = eta^2/2, sign(eta) = sign(lambda-1):
// series for |eta| < 0.5, fixed-trip Newton otherwise.
__device__ __forceinline__ float lam_of_eta(float eta, int trips) {
  if (fabsf(eta) < 0.5f) {
    return 1.0f + eta * (1.0f + eta * ((float)(1.0 / 3.0) + eta * ((float)(1.0 / 36.0) +
           eta * ((float)(-1.0 / 270.0) + eta * (float)(1.0 / 4320.0)))));
  }
  float cube = 1.0f + eta * (float)(1.0 / 3.0);
  cube = fmaxf(cube * cube * cube, (float)1e-12);
  float lam = eta >= 0.0f ? cube : fmaxf(cube, expf(-1.0f - 0.5f * eta * eta));
  const float tgt = 0.5f * eta * eta;
  for (int t = 0; t < trips; ++t) {
    const float f = lam - 1.0f - logf(fmaxf(lam, (float)1e-30)) - tgt;
    const float den = fabsf(lam - 1.0f) < (float)1e-12 ? (float)1e-12 : lam - 1.0f;
    lam = fmaxf(lam - f * lam * hh::rcp(den), (float)1e-30);
  }
  return lam;
}

// Gamma(alpha, 1) quantile at Phi(z), corrected saddlepoint inversion.
__device__ __forceinline__ float gamma_qtl(float alpha, float z) {
  const float inv_a = hh::rcp(alpha);
  const float eta0 = z * sqrtf(inv_a);
  float e1;
  if (fabsf(eta0) >= (float)0.1) {
    const float w = lam_of_eta(eta0, kGqNewtonE1) - 1.0f;
    e1 = logf(fmaxf(eta0 * hh::rcp(w), (float)1e-30)) * hh::rcp(eta0);
  } else {
    e1 = (float)(-1.0 / 3.0) + eta0 * (float)(1.0 / 36.0) + eta0 * eta0 * (float)(1.0 / 1620.0);
  }
  const float t = fminf(fmaxf(eta0 * (float)(1.0 / 7.5), -1.0f), 1.0f);
  float q2 = kGqP2[14];
#pragma unroll
  for (int i = 13; i >= 0; --i) q2 = q2 * t + kGqP2[i];
  float q3 = kGqP3[10];
#pragma unroll
  for (int i = 9; i >= 0; --i) q3 = q3 * t + kGqP3[i];
  const float eta = eta0 + inv_a * (e1 + inv_a * (q2 + inv_a * q3));
  return alpha * lam_of_eta(eta, kGqNewton);
}

// The Poisson(mu) count at u = 1 - w of a Sobol' top cell, which no fp32 cdf
// below 1 tells from 1: the smallest n <= kmax with P(N > n) <= w, from the
// tail summed downward.  The sum starts at kmax or at the first term past
// the mode below w 2^-24 (the rest of the tail is below w 2^-23), where the
// terms still sit far above FLT_MIN.
__device__ __forceinline__ float poisson_top_count(float mu, float w, int kmax) {
  float p = expf(-mu);
  int top = 0;
  for (int k = 1; k <= kmax; ++k) {
    const float q = p * mu * kInvK[k];
    if ((float)k > mu && q < w * (float)(1.0 / 16777216.0)) break;
    p = q;
    top = k;
  }
  float tail = 0.0f, n = (float)top;
  for (int k = top; k >= 1; --k) {
    tail = tail + p;  // P(N >= k)
    if (tail > w) break;
    n = (float)(k - 1);
    p = p * (float)k * hh::rcp(mu);
  }
  return n;
}

// One exact segment: (V, integrated V so far) -> (V', integrated V').  A
// negative u_pois is -w of a Sobol' top cell (hh::sobol_uniform_top).
__device__ __forceinline__ void exact_segment(float& v, float& iv, float u_pois, float z_gam,
                                              float u_boost, float z_iv, const ExactParams& c,
                                              int kmax) {
  // Poisson(lambda/2) count by CDF inversion; the count is final once
  // u <= cdf, since cdf only grows.
  const float mu = v * c.lam_fac;
  float n = 0.0f;
  if (u_pois < 0.0f) {
    n = poisson_top_count(mu, -u_pois, kmax);
  } else {
    float p = expf(-mu);
    float cdf = p;
    for (int k = 1; k <= kmax; ++k) {
      if (!(u_pois > cdf)) break;
      n = (float)k;
      p = p * mu * kInvK[k];
      cdf = cdf + p;
    }
  }

  // Gamma(d/2 + N, 2c) through the boosted corrected-saddlepoint quantile.
  const float alpha = c.d_half + n;
  const float u_safe = fmaxf(u_boost, (float)1e-30);
  const float g = gamma_qtl(alpha + 1.0f, z_gam) * expf(logf(u_safe) * hh::rcp(alpha));
  const float y = c.two_cfac * g;

  // Exact conditional moments of the integrated variance given (v, y).
  const float z = c.z_fac * sqrtf(fmaxf(v * y, (float)1e-30));
  const float W = z * bessel_ratio(z, c) + c.nu;
  const float xy = v + y;
  const float l1 = c.l1c - xy * c.l1x + W * c.q;
  const float l2 = c.l2c + xy * c.l2x + (z * z + c.nu2 - W - W * W) * c.q2 + W * c.p_c;
  const float m1 = fmaxf(c.m1f * l1, (float)1e-10);
  const float s2 = fmaxf(c.s2f * (l2 - l1 * c.inv_kappa), (float)1e-14);

  // Gamma-matched integrated-variance draw.
  const float inv_s2 = hh::rcp(s2);
  const float shape = m1 * m1 * inv_s2;
  const float scale = s2 * hh::rcp(m1);
  const float iv_seg = fmaxf(scale * gamma_qtl(shape, z_iv), (float)1e-10);
  v = y;
  iv = iv + iv_seg;
}

// J = (V_T - V_0 - kappa*theta*T)/sigma + (kappa/sigma)*IV, with c_j = V_0 +
// kappa*theta*T of `c`.
__device__ __forceinline__ float exact_j(float v, float iv, const ExactParams& c) {
  return (v - c.c_j) * c.inv_sigma + iv * c.k_over_sigma;
}

// The conditional BS close of (V_T, IV).
__device__ __forceinline__ float exact_close(float v, float iv, const ExactParams& c) {
  return hh::cond_bs_value(iv, exact_j(v, iv, c), c.close);
}

// The mirror's Poisson uniform: 1 - u, or w of a top cell's u_pois = -w.
__device__ __forceinline__ float mirror_pois(float u_pois) {
  return u_pois < 0.0f ? -u_pois : 1.0f - u_pois;
}

// The four draws of segment s of pair `pair` (point idx under QMC): Sobol'
// dims 4s..4s+3 of the (4*segments, 31) table `sobol` in shared memory, or
// Philox block s when `sobol` is null.
__device__ __forceinline__ void exact_draw(unsigned long long pair, uint32_t idx,
                                           const int* sobol, int s, uint32_t seed,
                                           uint32_t device_id, float& u_pois, float& z_gam,
                                           float& u_boost, float& z_iv) {
  if (sobol) {
    const int* rows = sobol + 4 * s * (hh::kSobolBits + 1);
    u_pois = hh::sobol_uniform_top(idx, rows);
    z_gam = hh::sobol_normal(idx, rows + (hh::kSobolBits + 1));
    u_boost = hh::sobol_uniform_open(idx, rows + 2 * (hh::kSobolBits + 1));
    z_iv = hh::sobol_normal(idx, rows + 3 * (hh::kSobolBits + 1));
  } else {
    const hh::U4 w = hh::philox_block(pair, (uint32_t)s, seed, device_id);
    hh::box_muller(w.x, w.y, z_gam, z_iv);
    u_pois = hh::uniform_from_bits(w.z);
    u_boost = hh::uniform_from_bits(w.w);
  }
}

// The four draws (u_pois, z_gam, u_boost, z_iv) of segment s of a pair.
struct ExactDraw {
  float u_pois, z_gam, u_boost, z_iv;
};

__device__ __forceinline__ ExactDraw swap_draw(const ExactDraw& d) {
  return ExactDraw{__shfl_xor_sync(0xffffffffu, d.u_pois, 1),
                   __shfl_xor_sync(0xffffffffu, d.z_gam, 1),
                   __shfl_xor_sync(0xffffffffu, d.u_boost, 1),
                   __shfl_xor_sync(0xffffffffu, d.z_iv, 1)};
}

// exact_draw shared by the two threads of a pair (`odd`: the second), each
// drawing half: under QMC the even thread draws dims 4s, 4s+1 (u_pois,
// z_gam) and the odd one 4s+2, 4s+3 (u_boost, z_iv); under Philox, at each
// even s the even thread draws block s and the odd one block s + 1, kept in
// `next` for segment s + 1.  Shuffles hand each thread the other's half.
// Steps come in increasing order, and every lane of the warp calls it.
// kSplit (K2, K3 staged): each Sobol' integer is the warp's staged high word (hw,
// candidate c; hh::stage_high) XOR hh::sobol_low of the point, the same
// integer hh::sobol_bits forms.
template <bool kSplit = false>
__device__ __forceinline__ ExactDraw exact_draw_shared(unsigned long long pair, uint32_t idx,
                                                       const int* sobol, int s, uint32_t seed,
                                                       uint32_t device_id, bool odd,
                                                       ExactDraw& next, const uint32_t* hw = nullptr,
                                                       int c = 0) {
  if (sobol) {
    const int dim = 4 * s + 2 * (int)odd;
    const int* rows = sobol + dim * (hh::kSobolBits + 1);
    float u, z;
    if constexpr (kSplit) {
      const uint32_t au = hw[2 * dim + c] ^ hh::sobol_low(idx, rows);
      const uint32_t az = hw[2 * dim + 2 + c] ^ hh::sobol_low(idx, rows + (hh::kSobolBits + 1));
      u = odd ? hh::sobol_uniform_open_of(au) : hh::sobol_uniform_top_of(au);
      z = hh::sobol_normal_of(az);
    } else {
      u = odd ? hh::sobol_uniform_open(idx, rows) : hh::sobol_uniform_top(idx, rows);
      z = hh::sobol_normal(idx, rows + (hh::kSobolBits + 1));
    }
    const float u_o = __shfl_xor_sync(0xffffffffu, u, 1);
    const float z_o = __shfl_xor_sync(0xffffffffu, z, 1);
    return odd ? ExactDraw{u_o, z_o, u, z} : ExactDraw{u, z, u_o, z_o};
  }
  if (s & 1) return next;
  ExactDraw own;
  exact_draw(pair, idx, sobol, s + (int)odd, seed, device_id, own.u_pois, own.z_gam, own.u_boost,
             own.z_iv);
  const ExactDraw other = swap_draw(own);
  next = odd ? own : other;
  return odd ? other : own;
}

// The value of one antithetic group of pair base + threadIdx.x / 2 of a
// round (an odd thread: the mirror), two threads a pair: the segments and
// the close in one pair a thread's operations and order, so the value keeps
// that kernel's bits.  kStaged QMC: the warp stages its high Sobol' words
// in hw (hh::stage_high; its 16 pairs are the points p0 .. p0 + 15, point
// idx taking candidate c) and each integer is the split draw's.  Every lane
// of the warp calls it, past the last pair too.
template <bool kStaged>
__device__ __forceinline__ float exact_group(long long base, const ExactParams& sp,
                                             const int* table, int segments, int kmax,
                                             uint32_t seed, uint32_t device_id,
                                             long long point_offset, uint32_t* hw) {
  const bool odd = threadIdx.x & 1;
  const long long g = base + (threadIdx.x >> 1);
  const unsigned long long pair = (unsigned long long)g;
  const uint32_t idx = (uint32_t)(point_offset + g);
  const uint32_t p0 = (uint32_t)(point_offset + base) + ((threadIdx.x & ~31u) >> 1);
  if (kStaged && table) hh::stage_high(table, 4 * segments, p0, hw);
  const int c = (int)(((p0 & 31u) + ((threadIdx.x & 31u) >> 1)) >> 5);
  float v = sp.v0, iv = 0.0f;
  ExactDraw next{};
  for (int s = 0; s < segments; ++s) {
    const ExactDraw d =
        exact_draw_shared<kStaged>(pair, idx, table, s, seed, device_id, odd, next, hw, c);
    exact_segment(v, iv, odd ? mirror_pois(d.u_pois) : d.u_pois, odd ? -d.z_gam : d.z_gam,
                  odd ? 1.0f - d.u_boost : d.u_boost, odd ? -d.z_iv : d.z_iv, sp, kmax);
  }
  return exact_close(v, iv, sp);
}

// Stage the parameter vector and the Sobol' table in shared memory (with
// kStaged false the table stays in global memory and is returned as given).
template <bool kStaged>
__device__ __forceinline__ const int* stage_inputs(const float* params, const int* sobol,
                                                   int segments, ExactParams& sp, int* ssob) {
  float* dst = reinterpret_cast<float*>(&sp);
  for (int i = threadIdx.x; i < kNumParams; i += blockDim.x) dst[i] = params[i];
  if constexpr (!kStaged) {
    __syncthreads();
    return sobol;
  }
  if (sobol) {
    const int n = 4 * segments * (hh::kSobolBits + 1);
    for (int i = threadIdx.x; i < n; i += blockDim.x) ssob[i] = sobol[i];
  }
  __syncthreads();
  return sobol ? ssob : nullptr;
}

// This warp's high Sobol' words past the staged table: 2 candidates of each
// of the 4 * segments dimensions (K2 and K3 staged under QMC).
__device__ __forceinline__ uint32_t* warp_high_words(int* ssob, int segments) {
  return reinterpret_cast<uint32_t*>(ssob + 4 * segments * (hh::kSobolBits + 1)) +
         (threadIdx.x >> 5) * 8 * segments;
}

// K2 under antithetic pairing, in K3's layout: block b takes the round of
// kRoundPairs consecutive pairs from b * kRoundPairs, thread 2q + h group h
// of its pair q, and writes its value to out[h * n_paths + pair].  Every
// lane walks, so every lane reaches the draw's shuffles; the store, not the
// walk, stops at n_paths.
template <bool kStaged>
__global__ void __launch_bounds__(kPairThreads, kPairBlocks)
exact_values_kernel(const float* __restrict__ params, const int* __restrict__ sobol,
                    float* __restrict__ out, long long n_paths, int segments, int kmax,
                    uint32_t seed, uint32_t device_id, long long point_offset) {
  __shared__ ExactParams sp;
  extern __shared__ int ssob[];
  const int* table = stage_inputs<kStaged>(params, sobol, segments, sp, ssob);
  uint32_t* hw = warp_high_words(ssob, segments);
  const long long base = (long long)blockIdx.x * kRoundPairs;
  const float val =
      exact_group<kStaged>(base, sp, table, segments, kmax, seed, device_id, point_offset, hw);
  const long long g = base + (threadIdx.x >> 1);
  if (g < n_paths) out[((threadIdx.x & 1) ? n_paths : 0) + g] = val;
}

// K2 without antithetic pairing: one path a thread, path i drawing what
// pair i would.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
exact_values_single_kernel(const float* __restrict__ params, const int* __restrict__ sobol,
                           float* __restrict__ out, long long n_paths, int segments, int kmax,
                           uint32_t seed, uint32_t device_id, long long point_offset) {
  __shared__ ExactParams sp;
  extern __shared__ int ssob[];
  const int* table = stage_inputs<kStaged>(params, sobol, segments, sp, ssob);
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_paths) return;
  const uint32_t idx = (uint32_t)(point_offset + i);
  float v = sp.v0, iv = 0.0f;
  for (int s = 0; s < segments; ++s) {
    float u_pois, z_gam, u_boost, z_iv;
    exact_draw((unsigned long long)i, idx, table, s, seed, device_id, u_pois, z_gam, u_boost,
               z_iv);
    exact_segment(v, iv, u_pois, z_gam, u_boost, z_iv, sp, kmax);
  }
  out[i] = exact_close(v, iv, sp);
}

// K3: K2's layout (exact_group), in K4's: a round of a block is
// kRoundPairs consecutive pairs and the stride grid x kRoundPairs pairs, so
// the even thread of pair q walks the pairs thread q walked one pair a
// thread, and adds value + antithetic value (one shuffle) to its fp32 sum in
// that order; the float64 tree runs over the same kRoundPairs sums.  At one
// grid the sums therefore keep their bits.
template <bool kStaged>
__global__ void __launch_bounds__(kPairThreads, kPairBlocks)
exact_price_kernel(const float* __restrict__ params, const int* __restrict__ sobol,
                   double* __restrict__ partials, long long total_pairs, int segments, int kmax,
                   uint32_t seed, uint32_t device_id, long long point_offset) {
  __shared__ ExactParams sp;
  __shared__ double red[kRoundPairs];
  extern __shared__ int ssob[];
  const int* table = stage_inputs<kStaged>(params, sobol, segments, sp, ssob);
  const int q = threadIdx.x >> 1;
  const bool odd = threadIdx.x & 1;
  uint32_t* hw = warp_high_words(ssob, segments);
  float acc = 0.0f;
  const long long stride = (long long)gridDim.x * kRoundPairs;
  for (long long base = (long long)blockIdx.x * kRoundPairs; base < total_pairs; base += stride) {
    const float val =
        exact_group<kStaged>(base, sp, table, segments, kmax, seed, device_id, point_offset, hw);
    const float val_a = __shfl_xor_sync(0xffffffffu, val, 1);
    if (!odd && base + q < total_pairs) acc += val + val_a;
  }
  if (!odd) red[q] = (double)acc;
  __syncthreads();
  for (int h = kRoundPairs / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) partials[blockIdx.x] = red[0];
}

size_t sobol_smem(const int* sobol, int segments) {
  return sobol ? sizeof(int) * 4 * segments * (hh::kSobolBits + 1) : 0;
}

// K2's and K3's staged dynamic shared memory: the table, then each warp's
// high words.
size_t pair_smem(bool qmc, int segments) {
  return qmc ? sizeof(int) * 4 * segments * (hh::kSobolBits + 1) +
                   sizeof(uint32_t) * (kPairThreads / 32) * 8 * segments
             : 0;
}

// K2's and K3's kernels under antithetic pairing.
using ValuesKernel = void (*)(const float*, const int*, float*, long long, int, int, uint32_t,
                             uint32_t, long long);
using PriceKernel = void (*)(const float*, const int*, double*, long long, int, int, uint32_t,
                            uint32_t, long long);

// Launches K2's or K3's staged or global-table kernel through
// launch(kernel, dynamic shared bytes): under QMC the staged one (the
// table and each warp's high words in shared memory, the split draw) where
// that leaves it kStagedBlocks blocks an SM (up to ~113 segments on an
// H100), else the one that reads the table from global memory at
// kPairBlocks blocks an SM; both form the same integers, so the same
// draws.  Under Philox the staged one, which then stages nothing.
template <class K, class F>
cudaError_t pair_launch(const int* sobol, int segments, K staged, K global, F&& launch) {
  const size_t smem = pair_smem(sobol != nullptr, segments);
  bool use_staged = sobol == nullptr;
  if (!use_staged && smem <= hh::smem_room(staged)) {
    int per_sm = 0;
    cudaError_t err = hh::allow_dynamic_smem(staged, smem);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, staged, kPairThreads, smem);
    }
    if (err != cudaSuccess) return err;
    use_staged = per_sm >= kStagedBlocks;
  }
  launch(use_staged ? staged : global, use_staged ? smem : 0);
  return cudaGetLastError();
}

// The occupancy of a two-threads-a-pair kernel (K2, K3) on the current
// device, taken at a fixed 16-row table (4 segments under QMC) whatever the
// launch's stream and segments, so those do not move a grid: out = (threads
// a block, resident blocks per SM, SMs, dynamic shared bytes, static shared
// bytes, registers a thread, local (spill) bytes a thread).
template <class K>
int pair_occupancy(K kernel, int* out) {
  const size_t smem = pair_smem(true, 4);
  int dev = 0, sms = 0, per_sm = 0;
  cudaFuncAttributes attr{};
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kPairThreads, smem);
  }
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  const int vals[7] = {kPairThreads, per_sm, sms, (int)smem, (int)attr.sharedSizeBytes,
                       attr.numRegs, (int)attr.localSizeBytes};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return (int)err;
}

// ---- K4: the exact-transition surface ----
//
// Replaces hedgehog_tpu/ops/heston_exact_kernel.py:
//   heston_exact_mixing_surface_price  (pallas_call at :779 QMC, :801 PRNG;
//                                       bodies _exact_surface_kernel[_qmc])
//
// One variance path per antithetic group through the expiry gaps (gap i:
// ints[i] exact segments with that gap's constants and Poisson trip count
// ints[n_exp + i], the segment index running across gaps); at each expiry the
// (V, IV) carries close every strike through J_i = (V - V0 - kappa theta
// T_i + kappa IV)/sigma.  The plain twin is ops/heston_exact_kernel.py
// heston_exact_mixing_surface_sums_plain.
//
// The segment is a long serial chain (the data-dependent Poisson loop, two
// gamma quantiles of fixed-trip Newton logs and reciprocals, a continued
// fraction of 16 dependent reciprocals), so the kernel is latency-bound.
// Two threads take a pair, one antithetic group each (thread 2q + h of a
// block, pair q of the round, h = 1 the mirror): twice the chains in flight
// of one pair a thread at 80 registers.  Under QMC each thread of a pair
// draws two of the segment's four Sobol' dimensions and the two swap them
// by a shuffle; a Philox block is drawn by both.  At each expiry a thread
// forms its group's strike-free close once (hh::close_group) and each
// strike's value from it (hh::close_value, cond_bs_close's operations in
// their order); the pair's value + antithetic value is one shuffle.  Each
// pair's values therefore keep their bits, and the sums keep theirs: a
// round of a block is 256 consecutive pairs as before, staged in shared
// memory (up to kXsStage points, whole expiries) so that one warp adds each
// 32 consecutive pairs by the same butterfly into the same float64 row
// (kXsRows rows, summed in row order).
// A grid-stride walk with one resident wave (hh_exact_surface_grid counts
// the dynamic shared memory below); the per-gap ExactParams and per-point
// close constants in shared memory.  Measured (PERF.md §6, H100): 40
// registers with a little spill (the Poisson top-cell branch), three blocks
// (48 warps) an SM; the shared Philox draws and the third block gave a few
// percent each, staging whole expiries rather than one at a time about 2%.
// What is left is the gamma quantiles' and the Bessel fraction's dependent
// chains, which keep each value's bits only in their order.

constexpr int kXsThreads = 512;              // two threads a pair
constexpr int kXsPairs = kXsThreads / 2;     // pairs a round of a block
constexpr int kXsRows = kXsPairs / 32;       // float64 rows: one a 32 consecutive pairs
constexpr int kXsWarps = kXsThreads / 32;
constexpr int kXsGlobals = 7;  // v0, rho, rho2_half, rho_bar2, cp, inv_sigma, k_over_sigma
constexpr int kXsShared = 12;  // d_half, nu, nu2, an1, an2, an3, ad1, ad2, ad3, m1f, s2f, inv_kappa
constexpr int kXsPerGap = 10;  // lam_fac, two_cfac, z_fac, l1c, l1x, l2c, l2x, q, q2, p_c
constexpr int kXsStage = 48;   // points a round stages before it adds them (whole expiries)

// Dynamic shared memory: the float64 row sums, a round's pair values at
// `cap` points (whole expiries: up to kXsStage points, or one expiry's m
// strikes where m is more), per-gap ExactParams, per-point close constants,
// segment counts then trip counts, the Sobol' table
// (ops/heston_exact_kernel.py exact_surface_smem_bytes mirrors it).
struct XsLayout {
  int n_cols, cap;
  size_t ys, gaps, close, ints, sobol, bytes;
};

__host__ __device__ inline XsLayout xs_layout(int n_exp, int m, int total_segs, bool qmc,
                                              bool staged = true) {
  XsLayout l;
  l.n_cols = n_exp * m;
  l.cap = m > kXsStage ? m : (l.n_cols < kXsStage ? l.n_cols : kXsStage);
  size_t off = sizeof(double) * kXsRows * l.n_cols;
  l.ys = off;
  off += sizeof(float) * kXsPairs * l.cap;
  l.gaps = off;
  off += sizeof(ExactParams) * n_exp;
  l.close = off;
  off += sizeof(hh::CloseParams) * l.n_cols;
  l.ints = off;
  off += sizeof(int) * 2 * n_exp;
  l.sobol = off;
  off += qmc && staged ? sizeof(int) * 4 * total_segs * (hh::kSobolBits + 1) : 0;
  l.bytes = off;
  return l;
}

// Expands the flat parameter vector (ops/heston_exact_kernel.py XS_GLOBALS,
// XS_SHARED, XS_PER_GAP per gap, f_base and c_j per expiry, strikes, log(F/K))
// into per-gap ExactParams and per-point CloseParams; zeroes the sums.
__device__ __forceinline__ void stage_surface(const float* params, const int* ints,
                                              const int* sobol, int n_exp, int m, int total_segs,
                                              const XsLayout& l, char* smem) {
  double* wacc = reinterpret_cast<double*>(smem);
  for (int i = threadIdx.x; i < kXsRows * l.n_cols; i += blockDim.x) wacc[i] = 0.0;
  const float* g = params;
  const float* sh = g + kXsGlobals;
  const float* f_base = sh + kXsShared + kXsPerGap * n_exp;
  const float* c_j = f_base + n_exp;
  const float* strike = c_j + n_exp;
  const float* lfk = strike + m;
  ExactParams* gaps = reinterpret_cast<ExactParams*>(smem + l.gaps);
  for (int i = threadIdx.x; i < n_exp; i += blockDim.x) {
    const float* gp = sh + kXsShared + kXsPerGap * i;
    ExactParams& e = gaps[i];
    e.close = hh::CloseParams{f_base[i], 0.0f, g[1], g[2], g[3], g[4], 0.0f};
    e.v0 = g[0];
    e.lam_fac = gp[0];
    e.d_half = sh[0];
    e.two_cfac = gp[1];
    e.nu = sh[1];
    e.nu2 = sh[2];
    e.z_fac = gp[2];
    e.an1 = sh[3];
    e.an2 = sh[4];
    e.an3 = sh[5];
    e.ad1 = sh[6];
    e.ad2 = sh[7];
    e.ad3 = sh[8];
    e.l1c = gp[3];
    e.l1x = gp[4];
    e.l2c = gp[5];
    e.l2x = gp[6];
    e.q = gp[7];
    e.q2 = gp[8];
    e.p_c = gp[9];
    e.m1f = sh[9];
    e.s2f = sh[10];
    e.inv_kappa = sh[11];
    e.c_j = c_j[i];
    e.k_over_sigma = g[6];
    e.inv_sigma = g[5];
  }
  hh::CloseParams* close = reinterpret_cast<hh::CloseParams*>(smem + l.close);
  for (int p = threadIdx.x; p < l.n_cols; p += blockDim.x) {
    close[p] = hh::CloseParams{f_base[p / m], strike[p % m], g[1], g[2], g[3], g[4], lfk[p]};
  }
  int* sints = reinterpret_cast<int*>(smem + l.ints);
  for (int i = threadIdx.x; i < 2 * n_exp; i += blockDim.x) sints[i] = ints[i];
  if (sobol) {
    int* ssob = reinterpret_cast<int*>(smem + l.sobol);
    const int n = 4 * total_segs * (hh::kSobolBits + 1);
    for (int i = threadIdx.x; i < n; i += blockDim.x) ssob[i] = sobol[i];
  }
  __syncthreads();
}

// Adds `count` staged points' pair values (points p0, p0 + 1, ...) into
// their float64 rows between two barriers: warp w takes each (row, point)
// task w, w + kXsWarps, ...
__device__ __forceinline__ void flush_points(const float* ys, double* wacc, int n_cols, int p0,
                                             int count) {
  __syncthreads();
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int task = w; task < kXsRows * count; task += kXsWarps) {
    const int row = task % kXsRows, k = task / kXsRows;
    hh::warp_accumulate(ys[k * kXsPairs + row * 32 + lane], wacc, n_cols, p0 + k, row);
  }
  __syncthreads();
}

// A round's pairs base + q, q < kXsPairs: each thread walks its group, and
// at each expiry the even thread of pair q puts the pair's value +
// antithetic value at the staged point j at ys[j * kXsPairs + q] (0 past
// total_pairs); the staged points are added when the next expiry would not
// fit and at the round's end.  The rounds and expiries are uniform over the
// block, so every lane reaches the shuffles and barriers.
template <bool kStaged>
__global__ void __launch_bounds__(kXsThreads, 3)
exact_surface_kernel(const float* __restrict__ params, const int* __restrict__ ints,
                     const int* __restrict__ sobol, double* __restrict__ partials, int n_exp,
                     int m, int total_segs, long long total_pairs, uint32_t seed,
                     uint32_t device_id, long long point_offset) {
  extern __shared__ __align__(16) char xs_smem[];
  const XsLayout l = xs_layout(n_exp, m, total_segs, sobol != nullptr, kStaged);
  stage_surface(params, ints, kStaged ? sobol : nullptr, n_exp, m, total_segs, l, xs_smem);
  double* wacc = reinterpret_cast<double*>(xs_smem);
  float* ys = reinterpret_cast<float*>(xs_smem + l.ys);
  const ExactParams* gaps = reinterpret_cast<const ExactParams*>(xs_smem + l.gaps);
  const hh::CloseParams* close = reinterpret_cast<const hh::CloseParams*>(xs_smem + l.close);
  const int* nseg = reinterpret_cast<const int*>(xs_smem + l.ints);
  const int* kmaxes = nseg + n_exp;
  const int* table =
      !sobol ? nullptr : kStaged ? reinterpret_cast<const int*>(xs_smem + l.sobol) : sobol;
  const int q = threadIdx.x >> 1;
  const bool odd = threadIdx.x & 1;
  const float v0 = params[0];
  const long long stride = (long long)gridDim.x * kXsPairs;
  for (long long base = (long long)blockIdx.x * kXsPairs; base < total_pairs; base += stride) {
    const long long g = base + q;
    const bool live = g < total_pairs;
    const unsigned long long pair = (unsigned long long)g;
    const uint32_t idx = (uint32_t)(point_offset + g);
    float v = v0, iv = 0.0f;
    ExactDraw next{};
    int seg = 0, filled = 0;
    for (int i = 0; i < n_exp; ++i) {
      const ExactParams& c = gaps[i];
      for (int k = 0; k < nseg[i]; ++k, ++seg) {
        const ExactDraw d = exact_draw_shared(pair, idx, table, seg, seed, device_id, odd, next);
        // one exact_segment for both threads (the mirror's draws by select)
        exact_segment(v, iv, odd ? mirror_pois(d.u_pois) : d.u_pois, odd ? -d.z_gam : d.z_gam,
                      odd ? 1.0f - d.u_boost : d.u_boost, odd ? -d.z_iv : d.z_iv, c, kmaxes[i]);
      }
      if (filled + m > l.cap) {
        flush_points(ys, wacc, l.n_cols, i * m - filled, filled);
        filled = 0;
      }
      const hh::CloseGroup cg = hh::close_group(iv, exact_j(v, iv, c), close[i * m]);
      for (int k = 0; k < m; ++k) {
        const int p = i * m + k;
        const float val = hh::close_value(cg, close[p].log_f_over_k, close[p].strike, close[p].cp);
        const float y = val + __shfl_xor_sync(0xffffffffu, val, 1);
        if (!odd) ys[(filled + k) * kXsPairs + q] = live ? y : 0.0f;
      }
      filled += m;
    }
    flush_points(ys, wacc, l.n_cols, l.n_cols - filled, filled);
  }
  hh::block_columns(wacc, l.n_cols, kXsRows, partials);
}

}  // namespace

// Per-path undiscounted values: out is (1 or 2, n_paths) float32.
extern "C" int hh_exact_values(const float* params, const int* sobol, float* out,
                               long long n_paths, int segments, int antithetic, int kmax,
                               unsigned seed, unsigned device_id, long long point_offset,
                               void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (!antithetic) {
    const long long blocks = (n_paths + kThreads - 1) / kThreads;
    const size_t smem = sobol_smem(sobol, segments);
    if (smem <= hh::smem_room(exact_values_single_kernel<true>)) {
      const cudaError_t err = hh::allow_dynamic_smem(exact_values_single_kernel<true>, smem);
      if (err != cudaSuccess) return (int)err;
      exact_values_single_kernel<true><<<(unsigned)blocks, kThreads, smem, st>>>(
          params, sobol, out, n_paths, segments, kmax, seed, device_id, point_offset);
    } else {
      exact_values_single_kernel<false><<<(unsigned)blocks, kThreads, 0, st>>>(
          params, sobol, out, n_paths, segments, kmax, seed, device_id, point_offset);
    }
    return (int)cudaGetLastError();
  }
  const unsigned blocks = (unsigned)((n_paths + kRoundPairs - 1) / kRoundPairs);
  return (int)pair_launch(sobol, segments, exact_values_kernel<true>, exact_values_kernel<false>,
                          [&](ValuesKernel kernel, size_t smem) {
                            kernel<<<blocks, kPairThreads, smem, st>>>(
                                params, sobol, out, n_paths, segments, kmax, seed, device_id,
                                point_offset);
                          });
}

// Sums of (value + antithetic value): partials is (grid,) float64, one per block.
extern "C" int hh_exact_price(const float* params, const int* sobol, double* partials, int grid,
                              long long total_pairs, int segments, int kmax, unsigned seed,
                              unsigned device_id, long long point_offset, void* stream) {
  return (int)pair_launch(sobol, segments, exact_price_kernel<true>, exact_price_kernel<false>,
                          [&](PriceKernel kernel, size_t smem) {
                            kernel<<<grid, kPairThreads, smem, (cudaStream_t)stream>>>(
                                params, sobol, partials, total_pairs, segments, kmax, seed,
                                device_id, point_offset);
                          });
}

// K3's occupancy (pair_occupancy).
extern "C" int hh_exact_price_occupancy(int* out) {
  return pair_occupancy(exact_price_kernel<true>, out);
}

// The price kernel's grid: one resident wave of it on the current device.
extern "C" int hh_exact_price_grid(int* grid) {
  int occ[7];
  const int err = hh_exact_price_occupancy(occ);
  *grid = occ[2] * (occ[1] > 0 ? occ[1] : 1);
  return err;
}

// K4 staged (the Sobol' table in shared memory) or reading the table from
// global memory: the caller decides (ops/heston_exact_kernel.py
// exact_surface_staged) and chunks the strikes to fit.
struct XsLaunch {
  const void* kernel;
  XsLayout l;
};

static XsLaunch xs_launch(int n_exp, int m, int total_segs, bool qmc, bool staged) {
  const void* kernel = staged ? (const void*)exact_surface_kernel<true>
                              : (const void*)exact_surface_kernel<false>;
  return {kernel, xs_layout(n_exp, m, total_segs, qmc, staged)};
}

// K4: out[n_exp * m] float64 sums over the pairs [0, total_pairs) of each
// point's (value + antithetic value), point-major; partials is (n_exp * m,
// grid) scratch; ints is [segments per gap..., Poisson trip count per
// gap...] int32; sobol the (4 * total_segs, 31) table for QMC or null,
// staged in shared memory where `staged`.
extern "C" int hh_exact_surface(const float* params, const int* ints, const int* sobol,
                                double* partials, double* out, int grid, int n_exp, int m,
                                int total_segs, long long total_pairs, unsigned seed,
                                unsigned device_id, long long point_offset, int staged,
                                void* stream) {
  const XsLaunch x = xs_launch(n_exp, m, total_segs, sobol != nullptr, staged != 0);
  cudaError_t err = cudaFuncSetAttribute(x.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)x.l.bytes);
  if (err != cudaSuccess) return (int)err;
  if (x.kernel == (const void*)exact_surface_kernel<true>) {
    exact_surface_kernel<true><<<grid, kXsThreads, x.l.bytes, (cudaStream_t)stream>>>(
        params, ints, sobol, partials, n_exp, m, total_segs, total_pairs, seed, device_id,
        point_offset);
  } else {
    exact_surface_kernel<false><<<grid, kXsThreads, x.l.bytes, (cudaStream_t)stream>>>(
        params, ints, sobol, partials, n_exp, m, total_segs, total_pairs, seed, device_id,
        point_offset);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return hh::launch_column_sums(partials, x.l.n_cols, grid, out, (cudaStream_t)stream);
}

// K4's occupancy on the current device for a surface of n_exp expiries, m
// strikes and total_segs segments, with or without the Sobol' table, staged
// or not: out = (threads a block, resident blocks per SM, SMs, dynamic
// shared bytes, static shared bytes, registers a thread, local (spill)
// bytes a thread).
extern "C" int hh_exact_surface_occupancy(int n_exp, int m, int total_segs, int qmc, int staged,
                                          int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  const XsLaunch x = xs_launch(n_exp, m, total_segs, qmc != 0, staged != 0);
  const size_t smem = x.l.bytes;
  cudaFuncAttributes attr{};
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(x.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, x.kernel, kXsThreads, smem);
  }
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, x.kernel);
  const int vals[7] = {kXsThreads, per_sm, sms, (int)smem, (int)attr.sharedSizeBytes,
                       attr.numRegs, (int)attr.localSizeBytes};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return (int)err;
}

// K4's grid: one resident wave on the current device at the launch's
// dynamic shared memory.
extern "C" int hh_exact_surface_grid(int n_exp, int m, int total_segs, int qmc, int staged,
                                     int* grid) {
  int occ[7];
  const int err = hh_exact_surface_occupancy(n_exp, m, total_segs, qmc, staged, occ);
  *grid = occ[2] * (occ[1] > 0 ? occ[1] : 1);
  return err;
}
