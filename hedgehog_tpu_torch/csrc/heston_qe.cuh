// Forward-tangent helpers of the QE mixing greek kernels (sm_90a), shared by
// heston_qe_greeks.cu (K10 price + 7 greeks, K11 the values VJP).
//
// Replaces the helpers of hedgehog_tpu/ops/heston_qe_greeks_kernel.py:
//   _qe_v_coeffs, _tan_init, _tan_step, _div_real, _dj_terms,
//   _cond_bs_partials
// Their plain PyTorch twins live in hedgehog_tpu_torch/ops/
// heston_qe_greeks_kernel.py; keep the two in step.
//
// Tangent directions, in table-row order: V0, kappa, theta, sigma [, T].
// The (n_dirs, 8) tangent table holds per direction the tangents of the
// V-draw constants (theta_c, e, c_s2_v, c_s2_c, and d(half_dt)/half_dt in
// column 4) and (alpha, beta, gamma) closing the telescoped J chain
// J = (V_T - V0 - kappa theta T + kappa IV)/sigma at the end of the path.
// Per step a path carries dV and the running sum S = sum_k dV_k for each
// direction; dIV = half_dt (2S - dV_0 - dV_T) closes at the end.
#pragma once

#include "hh_device.cuh"

namespace hh {

constexpr int kTanCols = 8;

// The QE draw and its tangent coefficients: dvn = cm dm + cs ds2 for the
// two moment channels m = theta + (v - theta) e and s2 = v c_s2_v + c_s2_c.
// The primal is qe_v_draw's, to the bit; the coefficients reuse its
// intermediates.  Clamped lanes (psi at its floor, p at its clip, 1/beta at
// its cap, u <= p) have zero slope through the clamped quantity.
// P is MixParams or SurfSeg.
template <class P>
__device__ __forceinline__ float qe_v_coeffs(float v, float z, float u, const P& c, float& cm,
                                             float& cs) {
  QeDraw d;
  const float vn = qe_v_draw(v, z, u, c, d);
  float coef_m = 0.0f, coef_psi = 0.0f;
  if (d.quad) {
    // on quad lanes t1 = 2/psi - 1 >= 1/3, so its clamp is never active
    const float t_psi = -d.top * d.inv_psi;
    const float rcp_prod = rcp(fmaxf(d.sqw * d.sqb, (float)1e-30));
    const float rcp_sqw = d.sqb * rcp_prod;
    const float rcp_sqb = d.sqw * rcp_prod;
    const float db2_dpsi = t_psi * (1.0f + 0.5f * rcp_sqw * (d.t1 + d.top));
    const float q_m = d.q * d.q * d.rb;
    coef_m = q_m;
    coef_psi = d.a * (d.q * rcp_sqb - q_m) * db2_dpsi;
  } else if (d.e_live) {
    // p below its clip <=> (psi + 1)/2 below the 1/beta cap: one mask for
    // both plateaus; there d(v_exp)/dpsi = m (L - 1)/2
    coef_m = d.lterm * d.capfac;
    if (d.p_raw < (float)(1.0 - 1e-6)) coef_psi = (0.5f * d.m_safe) * (d.lterm - 1.0f);
  }
  if (!(d.psi_raw > (float)1e-6)) coef_psi = 0.0f;  // psi-floor plateau
  cm = coef_m - 2.0f * d.psi * d.inv_m * coef_psi;
  cs = coef_psi * d.inv_m * d.inv_m;
  return vn;
}

template <int kDirs>
struct TanState {
  float v, iv, j;
  float dv[kDirs], s[kDirs];
};

template <int kDirs>
__device__ __forceinline__ void tan_init(TanState<kDirs>& st, const MixParams& c) {
  st.v = c.v0;
  st.iv = 0.0f;
  st.j = 0.0f;
#pragma unroll
  for (int d = 0; d < kDirs; ++d) {
    st.dv[d] = d == 0 ? 1.0f : 0.0f;  // dV/dV0 = 1 at t = 0
    st.s[d] = st.dv[d];
  }
}

// One mixing step with forward tangents.  Which V-draw constants a direction
// moves: V0 none; kappa e, c_s2_v, c_s2_c; theta theta_c, c_s2_c; sigma
// c_s2_v, c_s2_c; T e, c_s2_v, c_s2_c (and half_dt, closed in div_real).
template <int kDirs>
__device__ __forceinline__ void tan_step(TanState<kDirs>& st, float z, float u,
                                         const MixParams& c, const float (*tab)[kTanCols]) {
  float cm, cs;
  const float vn = qe_v_coeffs(st.v, z, u, c, cm, cs);
  const float a_coef = cm * c.e + cs * c.c_s2_v;
  const float col0 = cm * (1.0f - c.e);
  const float col1 = cm * (st.v - c.theta);
  const float col2 = cs * st.v;
  const float col3 = cs;
  float dvn[kDirs];
  dvn[0] = a_coef * st.dv[0];
  dvn[1] = a_coef * st.dv[1] + col1 * tab[1][1] + col2 * tab[1][2] + col3 * tab[1][3];
  dvn[2] = a_coef * st.dv[2] + col0 * tab[2][0] + col3 * tab[2][3];
  dvn[3] = a_coef * st.dv[3] + col2 * tab[3][2] + col3 * tab[3][3];
  if constexpr (kDirs > 4) {
    dvn[4] = a_coef * st.dv[4] + col1 * tab[4][1] + col2 * tab[4][2] + col3 * tab[4][3];
  }
#pragma unroll
  for (int d = 0; d < kDirs; ++d) {
    st.dv[d] = dvn[d];
    st.s[d] = st.s[d] + dvn[d];
  }
  mix_update(st.v, st.iv, st.j, vn, c);
}

// dIV of direction d from the running sum: half_dt (2S - dV_0 - dV_T), plus
// (d half_dt / half_dt) IV for the T direction.
template <int kDirs>
__device__ __forceinline__ float div_real(const TanState<kDirs>& st, const MixParams& c,
                                          const float (*tab)[kTanCols], int d) {
  float trap = 2.0f * st.s[d] - st.dv[d];
  if (d == 0) trap = trap - 1.0f;
  float out = c.half_dt * trap;
  if (kDirs > 4 && d == 4) out = out + tab[kDirs - 1][4] * st.iv;
  return out;
}

// dJ of direction d: dV_T/sigma + (kappa/sigma) dIV + alpha IV + beta + gamma J.
template <int kDirs>
__device__ __forceinline__ float dj_terms(const TanState<kDirs>& st, const MixParams& c,
                                          const float (*tab)[kTanCols], int d, float div_d) {
  return c.inv_sigma * st.dv[d] + c.k_over_sigma * div_d + tab[d][5] * st.iv + tab[d][6] +
         tab[d][7] * st.j;
}

// The conditional BS value and its partials: y, dY/dIV, dY/dJ, dY/drho,
// w = (dY/dF) F (= dY/dlogS0), and Phi(cp d2) for dY/dK = -cp Phi(cp d2).
struct BsPartials {
  float y, y_iv, y_j, y_rho, w, phi2;
};

__device__ __forceinline__ BsPartials cond_bs_partials(float iv, float j, const CloseParams& c) {
  BsClose b;
  BsPartials o;
  o.y = cond_bs_close(iv, j, c, b);
  o.w = c.cp * b.phi1 * b.f_eff;
  const float vega_sd = b.f_eff * (float)0.3989422804014327 * expf(-0.5f * b.d1 * b.d1);
  o.y_iv = o.w * (-c.rho2_half) + vega_sd * c.rho_bar2 * 0.5f * b.inv_sd;
  o.y_j = o.w * c.rho;
  o.y_rho = o.w * (j - c.rho * iv) - vega_sd * c.rho * iv * b.inv_sd;
  o.phi2 = b.phi2;
  return o;
}

// cond_bs_partials split at the strike, in its operations and order: the
// partials at one strike from the strike-free part of the same (IV, J)
// under the expiry's f_base (hh::close_group, formed once per path and
// expiry), each field to the bit cond_bs_partials's in the surface kernel
// before the split (and in K10, one strike, before its redesign).  The vega's exponential of -d1^2/2 is the one
// Phi(cp d1) takes (|cp d1| = |d1|, and halving and negating are exact), so
// the two share it.  y_rho is pinned as that kernel's code formed it (its
// SASS): w (j - rho IV), with j - rho IV one FMA, less the vega term, the
// product rounded before the subtraction for the + group (kMirror false)
// and fused with it for the mirror.
template <bool kMirror>
__device__ __forceinline__ BsPartials close_partials(const CloseGroup& g, float iv, float j,
                                                     const CloseParams& c) {
  BsPartials o;
  const float d1 = (c.log_f_over_k + g.e_arg + 0.5f * g.var) * g.inv_sd;
  const float d2 = d1 - g.sd;
  const float e1 = expf(-0.5f * d1 * d1);
  const float phi1 = norm_cdf_exp(c.cp * d1, e1);
  o.phi2 = norm_cdf(c.cp * d2);
  o.y = c.cp * (g.f_eff * phi1 - c.strike * o.phi2);
  o.w = c.cp * phi1 * g.f_eff;
  const float vega_sd = g.f_eff * (float)0.3989422804014327 * e1;
  o.y_iv = o.w * (-c.rho2_half) + vega_sd * c.rho_bar2 * 0.5f * g.inv_sd;
  o.y_j = o.w * c.rho;
  const float jr = __fmaf_rn(-c.rho, iv, j);
  const float vterm = __fmul_rn(__fmul_rn(__fmul_rn(vega_sd, c.rho), iv), g.inv_sd);
  o.y_rho = kMirror ? __fmaf_rn(o.w, jr, -vterm) : __fsub_rn(__fmul_rn(o.w, jr), vterm);
  return o;
}

// ---- The split Sobol' draw (K9, K12 in heston_surface.cu; K7, K8, K10, K11) ----
//
// A warp's 32 lanes take 32 consecutive points, so a point's bits >= 5 are
// one of two warp-uniform values (hh_device.cuh sobol_high, sobol_low,
// stage_high).

// The (z, u) of steps [step, end) of one pair (point idx), passed in step
// order to advance(z, u): mix_draws's numbers over a surface's steps (K9,
// K12) or over one path's (K7, K8, K10, K11: step 0 to steps), on the
// stream kQmc names, so that a build for one stream holds no code of the
// other.  Under Philox one block per two steps in mix_draws's order,
// running across the segments (the step index counts the whole
// trajectory, so a segment that ends on an even step leaves the block's
// second normal and word, z_odd and w_odd, to the next segment's first
// step).  Under QMC the Sobol' pair of step s: staged (kSplit), each
// integer the warp's high word (hw, candidate c) XOR sobol_low of the
// point; else the table in global memory through sobol_bits.
template <bool kQmc, bool kSplit, class F>
__device__ __forceinline__ void draw_steps(unsigned long long pair, uint32_t idx, const int* sobol,
                                           const uint32_t* hw, int c, uint32_t seed,
                                           uint32_t device_id, int step, int end, float& z_odd,
                                           uint32_t& w_odd, F&& advance) {
  if constexpr (kQmc && kSplit) {
    // the point's low-bit masks, formed once and held: left free, ptxas
    // formed them again every step in K7 (17 more instructions a step, 6%
    // of K7 at 2^22 pairs on an H100, PERF.md)
    uint32_t m[5];
    sobol_low_masks(idx, m);
    asm volatile("" : "+r"(m[0]), "+r"(m[1]), "+r"(m[2]), "+r"(m[3]), "+r"(m[4]));
    for (int s = step; s < end; ++s) {
      const int* rows = sobol + 2 * s * (kSobolBits + 1);
      const uint32_t az = hw[4 * s + c] ^ sobol_low_of(m, rows);
      const uint32_t au = hw[4 * s + 2 + c] ^ sobol_low_of(m, rows + kSobolBits + 1);
      advance(sobol_normal_of(az), sobol_uniform_open_of(au));
    }
  } else if constexpr (kQmc) {
    for (int s = step; s < end; ++s) {
      const int* rows = sobol + 2 * s * (kSobolBits + 1);
      advance(sobol_normal(idx, rows), sobol_uniform_open(idx, rows + kSobolBits + 1));
    }
  } else {
    int s = step;
    if (s & 1) {  // a segment has >= 1 step, so the block of step s - 1 was drawn
      advance(z_odd, uniform_from_bits(w_odd));
      ++s;
    }
    for (; s + 1 < end; s += 2) {
      const U4 w = philox_block(pair, (uint32_t)(s >> 1), seed, device_id);
      float z0, z1;
      box_muller(w.x, w.y, z0, z1);
      advance(z0, uniform_from_bits(w.z));
      advance(z1, uniform_from_bits(w.w));
    }
    if (s < end) {
      const U4 w = philox_block(pair, (uint32_t)(s >> 1), seed, device_id);
      float z0;
      box_muller(w.x, w.y, z0, z_odd);
      advance(z0, uniform_from_bits(w.z));
      w_odd = w.w;
    }
  }
}

// The (z_v, z_x, u) of each of `steps` steps of one pair (point idx) from
// the staged table (K5 under QMC), passed in step order to advance(z_v,
// z_x, u): qem_draws's numbers, dims 3s, 3s+1 and 3s+2 of the point, each
// integer the warp's high word (hw, candidate c) XOR sobol_low of the point.
template <class F>
__device__ __forceinline__ void qem_split_steps(uint32_t idx, const int* sobol, const uint32_t* hw,
                                                int c, int steps, F&& advance) {
  for (int s = 0; s < steps; ++s) {
    const int* rows = sobol + 3 * s * (kSobolBits + 1);
    const uint32_t* h = hw + 6 * s + c;
    const uint32_t av = h[0] ^ sobol_low(idx, rows);
    const uint32_t ax = h[2] ^ sobol_low(idx, rows + kSobolBits + 1);
    const uint32_t au = h[4] ^ sobol_low(idx, rows + 2 * (kSobolBits + 1));
    advance(sobol_normal_of(av), sobol_normal_of(ax), sobol_uniform_open_of(au));
  }
}

// This warp's high Sobol' words past a staged table of `dims` dimensions:
// 2 candidates of each (stage_high), kStaged K5, K7 and K11.
__device__ __forceinline__ uint32_t* warp_high_words(int* ssob, int dims) {
  return reinterpret_cast<uint32_t*>(ssob + dims * (kSobolBits + 1)) + (threadIdx.x >> 5) * 2 * dims;
}

// The staged dynamic shared memory of a QMC launch of `threads` threads a
// block over a table of `dims` dimensions: the table, then each warp's high
// words.
inline size_t split_smem(int dims, int threads) {
  return sizeof(int) * dims * (kSobolBits + 1) + sizeof(uint32_t) * (threads / 32) * 2 * dims;
}

// The fewest blocks an SM at which K5, K7 and K11 stage the split draw, as
// K2 and K3 do: at 2 the staged split draw beat the table in global memory,
// at 1 it lost (PERF.md §6).  Past it they read the table from global memory.
constexpr int kStagedBlocks = 2;

// Whether the staged build `kernel` runs at `smem` dynamic shared bytes
// with kStagedBlocks blocks an SM or more (opting it into that memory).
template <class K>
inline cudaError_t split_fits(K kernel, int threads, size_t smem, bool* fits) {
  *fits = false;
  if (smem > smem_room(kernel)) return cudaSuccess;
  int per_sm = 0;
  cudaError_t err = allow_dynamic_smem(kernel, smem);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  }
  *fits = err == cudaSuccess && per_sm >= kStagedBlocks;
  return err;
}

// The parameter struct P (floats only), the tangent table (kDirs rows; none
// for the primal kernels) and the Sobol' table (kDimsPerStep dims per step:
// 2 for mixing, 3 for QE-M) into shared memory, for the QE kernels of
// heston_qe.cu, heston_qe_greeks.cu and heston_qe_terminal.cu.  With
// kStaged false the table stays in global memory and is returned as given
// (the launch takes no dynamic shared memory).
template <int kDirs, int kDimsPerStep, class P, bool kStaged = true>
__device__ __forceinline__ const int* stage_inputs(const float* params, const float* tab,
                                                   const int* sobol, int steps, P& sp,
                                                   float (*stab)[kTanCols], int* ssob) {
  float* dst = reinterpret_cast<float*>(&sp);
  for (int i = threadIdx.x; i < (int)(sizeof(P) / sizeof(float)); i += blockDim.x) {
    dst[i] = params[i];
  }
  for (int i = threadIdx.x; i < kDirs * kTanCols; i += blockDim.x) {
    stab[i / kTanCols][i % kTanCols] = tab[i];
  }
  if constexpr (!kStaged) {
    __syncthreads();
    return sobol;
  }
  if (sobol) {
    const int n = kDimsPerStep * steps * (kSobolBits + 1);
    for (int i = threadIdx.x; i < n; i += blockDim.x) ssob[i] = sobol[i];
  }
  __syncthreads();
  return sobol ? ssob : nullptr;
}

// Sum kCols per-thread columns (float or double) over the block in float64
// with a halving tree in shared memory (one tree for the price kernels and
// the greek kernels alike) and write column k's sum to
// partials[k * gridDim.x + blockIdx.x].
template <int kThreads, int kCols, class T>
__device__ __forceinline__ void block_sums(const T (&acc)[kCols], double* red,
                                           double* partials) {
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    red[threadIdx.x] = (double)acc[k];
    __syncthreads();
    for (int h = kThreads / 2; h > 0; h >>= 1) {
      if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
      __syncthreads();
    }
    if (threadIdx.x == 0) partials[(long long)k * gridDim.x + blockIdx.x] = red[0];
    __syncthreads();
  }
}

}  // namespace hh
