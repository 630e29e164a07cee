// QE mixing surface kernels for sm_90a: a whole (expiry x strike) surface
// (K9) and the surface with its 7-parameter Jacobian (K12), one launch each.
//
// Replaces hedgehog_tpu/ops/heston_qe_kernel.py:
//   heston_qe_mixing_surface_price              (pallas_call at :1114 QMC,
//       :1136 PRNG; bodies _qe_mixing_surface_kernel[_qmc])
// and hedgehog_tpu/ops/heston_qe_greeks_kernel.py:
//   heston_qe_mixing_surface_price_and_jacobian (pallas_call at :1007 QMC,
//       :1023 PRNG; bodies _surface_greeks_kernel[_qmc])
//
// One variance path per antithetic pair runs through the expiry segments
// (segment i: nsteps[i] QE mixing steps with its own dt); at each segment's
// end the (IV, J) carries of both paths close every strike of that expiry
// with the conditional Black-Scholes formula.  K12 carries forward tangents
// of (V, IV) in the directions (V0, kappa, theta, sigma) -- dIV directly,
// since dt changes between segments -- closes J's tangent at each expiry
// from the expiry's (alpha, beta, gamma) row, and spot, rho and the rate
// from the conditional BS partials: seven columns per point.  The plain
// PyTorch twins are in hedgehog_tpu_torch/ops/heston_qe_kernel.py (K9) and
// ops/heston_qe_greeks_kernel.py (K12).
//
// What bounds them on this card: FP32 and MUFU issue, as K8/K10: per pair
// and step two QE draws (K12 with their tangent coefficients), per pair and
// point two conditional BS closes (K12 with their partials); memory is no
// bound (one float64 per point and block).  The design: one antithetic pair
// per thread and a grid-stride walk over the pairs with a grid that is a
// whole number of resident waves of both kernels; the segment constants,
// the per-point close constants, K12's tangent rows and the Sobol' table
// staged in shared memory; per-point sums per warp in float64 rows of shared
// memory (hh::warp_accumulate), so the per-thread state does not grow with
// the grid (51 points x 7 columns at the calibration shape).  K12 walks K9's
// pairs with K9's grid, and its surface column goes through the same primal,
// close and sums as K9's, so the two surfaces are equal to the bit.
//
// K9 (measured on an H100 at 2^26 pairs, 3 x 5, QE-32: PERF.md) spent a
// third of its time in the walk, a quarter in 30 full closes a pair and on
// Philox a quarter (under QMC half) in the draw: hh::sobol_bits walks all 30
// bits of the point for each dimension.  Both kernels now close each path
// once per expiry up to the strike (hh::close_group) and each strike from
// there (K9 hh::close_value, cond_bs_value's bits; K12 hh::close_partials,
// cond_bs_partials's bits, the strike's Phi(cp d1) sharing the vega's
// exponential); draw Philox two steps a block across the segments without
// a per-step parity branch (draw_steps); and under QMC split each Sobol'
// integer at bit 5: a warp's 32 consecutive points share their high bits,
// so the warp stages the two candidate high words of every dimension once
// a round (stage_high) and each point XORs in its low five rows.  The
// numbers drawn are hh::mix_draws's, so every pair keeps its bits and the
// sums theirs at the same grid.  K12 at 114 registers held 2 blocks an SM;
// it is built for 3 (__launch_bounds__(256, kJacBlocks)), so the grid,
// SMs x lcm(4, 3), is 1584 blocks on an H100 where it was 528.
//
// A Sobol' table that would take a one-strike launch past the shared memory
// the wrappers allow (ops/heston_qe_kernel.py SURFACE_SMEM_LIMIT: past
// about 540 steps over all expiries) is read from global memory instead
// (kStaged false), its integers formed unsplit by hh::sobol_bits: the same
// numbers.

#include <numeric>

#include "heston_qe.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDirs = 4;     // V0, kappa, theta, sigma
constexpr int kJacCols = 7;  // y, chain x 4, w, y_rho
constexpr int kGlobals = 8;  // v0, theta, inv_sigma, k_over_sigma, rho, rho2_half, rho_bar2, cp
constexpr int kPerSeg = 5;   // e, c_s2_v, c_s2_c, half_dt, ktd_over_sigma
constexpr int kJacBlocks = 3;  // K12's blocks an SM (its register budget: 85)

using hh::draw_steps;  // the split Sobol' draw (heston_qe.cuh), shared with K7, K8, K10, K11
using hh::stage_high;

// draw_steps on the stream kQmc names (1 Sobol', 0 Philox: K12 is built
// once per stream), or on the one `sobol` names at run time (-1: K9's one
// body for both).
template <int kQmc, bool kSplit, class F>
__device__ __forceinline__ void draw_segment(unsigned long long pair, uint32_t idx,
                                             const int* sobol, const uint32_t* hw, int c,
                                             uint32_t seed, uint32_t device_id, int step, int end,
                                             float& z_odd, uint32_t& w_odd, F&& advance) {
  if constexpr (kQmc >= 0) {
    draw_steps<kQmc == 1, kSplit>(pair, idx, sobol, hw, c, seed, device_id, step, end, z_odd,
                                  w_odd, advance);
  } else if (sobol) {
    draw_steps<true, kSplit>(pair, idx, sobol, hw, c, seed, device_id, step, end, z_odd, w_odd,
                             advance);
  } else {
    draw_steps<false, kSplit>(pair, idx, sobol, hw, c, seed, device_id, step, end, z_odd, w_odd,
                              advance);
  }
}

// Dynamic shared memory of one launch, in this order (the float64 rows first
// for their alignment): per-warp sums, segment constants, per-point close
// constants, K12's (4, 4) constant tangents and (4, 3) J-closure rows per
// expiry, step counts, the Sobol' table, and the per-warp high Sobol' words
// (two candidates a dimension: hh::sobol_high of the warp's first point
// rounded down to 32, and of the next 32).  The last two only where the
// table is staged.
struct Layout {
  int n_cols;
  size_t segs, close, dct, djt, steps, sobol, high, bytes;
};

__host__ __device__ inline Layout layout(int n_exp, int m, int total_steps, bool jac, bool qmc,
                                         bool staged) {
  Layout l;
  const int points = n_exp * m;
  const bool table = qmc && staged;
  l.n_cols = points * (jac ? kJacCols : 1);
  size_t off = sizeof(double) * kWarps * l.n_cols;
  l.segs = off;
  off += sizeof(hh::SurfSeg) * n_exp;
  l.close = off;
  off += sizeof(hh::CloseParams) * points;
  l.dct = off;
  off += jac ? sizeof(float) * kDirs * 4 * n_exp : 0;
  l.djt = off;
  off += jac ? sizeof(float) * kDirs * 3 * n_exp : 0;
  l.steps = off;
  off += sizeof(int) * n_exp;
  l.sobol = off;
  off += table ? sizeof(int) * 2 * total_steps * (hh::kSobolBits + 1) : 0;
  l.high = off;
  off += table ? sizeof(uint32_t) * kWarps * 2 * (2 * total_steps) : 0;
  l.bytes = off;
  return l;
}

// Expands the flat parameter vector (ops/hh_device.py SURF_GLOBALS,
// SURF_PER_SEG per segment, f_base per expiry, strikes, log(F/K)) into
// SurfSeg and CloseParams structs and copies the rest (the Sobol' table
// when `sobol` is given); zeroes the sums.
__device__ __forceinline__ void stage(const float* params, const int* nsteps, const float* dct,
                                      const float* djt, const int* sobol, int n_exp, int m,
                                      int total_steps, const Layout& l, char* smem) {
  double* wacc = reinterpret_cast<double*>(smem);
  for (int i = threadIdx.x; i < kWarps * l.n_cols; i += blockDim.x) wacc[i] = 0.0;
  hh::SurfSeg* segs = reinterpret_cast<hh::SurfSeg*>(smem + l.segs);
  for (int i = threadIdx.x; i < n_exp; i += blockDim.x) {
    const float* s = params + kGlobals + kPerSeg * i;
    segs[i] = hh::SurfSeg{params[1], s[0], s[1], s[2], s[3], params[2], params[3], s[4]};
  }
  const float* f_base = params + kGlobals + kPerSeg * n_exp;
  const float* strike = f_base + n_exp;
  const float* lfk = strike + m;
  hh::CloseParams* close = reinterpret_cast<hh::CloseParams*>(smem + l.close);
  for (int p = threadIdx.x; p < n_exp * m; p += blockDim.x) {
    close[p] = hh::CloseParams{f_base[p / m], strike[p % m], params[4], params[5], params[6],
                               params[7], lfk[p]};
  }
  if (dct) {
    float* sdct = reinterpret_cast<float*>(smem + l.dct);
    float* sdjt = reinterpret_cast<float*>(smem + l.djt);
    for (int i = threadIdx.x; i < kDirs * 4 * n_exp; i += blockDim.x) sdct[i] = dct[i];
    for (int i = threadIdx.x; i < kDirs * 3 * n_exp; i += blockDim.x) sdjt[i] = djt[i];
  }
  int* ssteps = reinterpret_cast<int*>(smem + l.steps);
  for (int i = threadIdx.x; i < n_exp; i += blockDim.x) ssteps[i] = nsteps[i];
  if (sobol) {
    int* ssob = reinterpret_cast<int*>(smem + l.sobol);
    const int n = 2 * total_steps * (hh::kSobolBits + 1);
    for (int i = threadIdx.x; i < n; i += blockDim.x) ssob[i] = sobol[i];
  }
  __syncthreads();
}

// K9: the pair's value at every point, added to the per-warp sums.  At each
// expiry each path's close is split at the strike (hh::close_group once,
// hh::close_value per strike: cond_bs_value's bits).
template <bool kSplit, int kQmc>
__device__ __forceinline__ void price_pair(unsigned long long pair, bool live, const int* sobol,
                                           const uint32_t* hw, int c, uint32_t seed,
                                           uint32_t device_id, long long point_offset, float v0,
                                           const hh::SurfSeg* segs,
                                           const hh::CloseParams* close, const int* nsteps,
                                           int n_exp, int m, double* wacc, int n_cols) {
  float v = v0, iv = 0.0f, j = 0.0f, va = v0, iva = 0.0f, ja = 0.0f;
  const uint32_t idx = (uint32_t)(point_offset + (long long)pair);
  float z_odd = 0.0f;  // the second normal and word of the last block drawn
  uint32_t w_odd = 0u;
  int step = 0;
  for (int i = 0; i < n_exp; ++i) {
    const hh::SurfSeg sc = segs[i];
    const int end = step + nsteps[i];
    if (live) {
      draw_segment<kQmc, kSplit>(pair, idx, sobol, hw, c, seed, device_id, step, end, z_odd,
                                 w_odd, [&](float z, float u) {
                                   hh::mix_advance(v, iv, j, z, u, sc);
                                   hh::mix_advance(va, iva, ja, -z, 1.0f - u, sc);
                                 });
    }
    step = end;
    const hh::CloseGroup g = hh::close_group(iv, j, close[i * m]);
    const hh::CloseGroup ga = hh::close_group(iva, ja, close[i * m]);
    for (int k = 0; k < m; ++k) {
      const int p = i * m + k;
      const hh::CloseParams& q = close[p];
      const float y = live ? hh::close_value(g, q.log_f_over_k, q.strike, q.cp) +
                                 hh::close_value(ga, q.log_f_over_k, q.strike, q.cp)
                           : 0.0f;
      hh::warp_accumulate(y, wacc, n_cols, p);
    }
  }
}

// One path's state with forward tangents of V and IV.
struct SurfTan {
  float v, iv, j;
  float dv[kDirs], div[kDirs];
};

__device__ __forceinline__ void tan_init_surface(SurfTan& st, float v0) {
  st.v = v0;
  st.iv = 0.0f;
  st.j = 0.0f;
#pragma unroll
  for (int d = 0; d < kDirs; ++d) {
    st.dv[d] = d == 0 ? 1.0f : 0.0f;  // dV/dV0 = 1 at t = 0
    st.div[d] = 0.0f;
  }
}

// One surface step with tangents; dct is the segment's (4, 4) table of the
// tangents of (theta_c, e, c_s2_v, c_s2_c).  Which constants a direction
// moves: V0 none; kappa e, c_s2_v, c_s2_c; theta theta_c, c_s2_c; sigma
// c_s2_v, c_s2_c.  The primal is K9's step (qe_v_coeffs returns qe_v_draw's
// value, then mix_update).
__device__ __forceinline__ void tan_step_surface(SurfTan& st, float z, float u,
                                                 const hh::SurfSeg& c, const float (*dct)[4]) {
  float cm, cs;
  const float vn = hh::qe_v_coeffs(st.v, z, u, c, cm, cs);
  const float a_coef = cm * c.e + cs * c.c_s2_v;
  const float col0 = cm * (1.0f - c.e);
  const float col1 = cm * (st.v - c.theta);
  const float col2 = cs * st.v;
  const float col3 = cs;
  float dvn[kDirs];
  dvn[0] = a_coef * st.dv[0];
  dvn[1] = a_coef * st.dv[1] + col1 * dct[1][1] + col2 * dct[1][2] + col3 * dct[1][3];
  dvn[2] = a_coef * st.dv[2] + col0 * dct[2][0] + col3 * dct[2][3];
  dvn[3] = a_coef * st.dv[3] + col2 * dct[3][2] + col3 * dct[3][3];
#pragma unroll
  for (int d = 0; d < kDirs; ++d) {
    st.div[d] = st.div[d] + c.half_dt * (st.dv[d] + dvn[d]);
    st.dv[d] = dvn[d];
  }
  hh::mix_update(st.v, st.iv, st.j, vn, c);
}

// dJ in direction d at an expiry: dV/sigma + (kappa/sigma) dIV + alpha IV +
// beta + gamma J, with the expiry's (alpha, beta, gamma) row.
__device__ __forceinline__ float surf_dj(const SurfTan& st, const hh::SurfSeg& c,
                                         const float* row, int d) {
  return c.inv_sigma * st.dv[d] + c.k_over_sigma * st.div[d] + row[0] * st.iv + row[1] +
         row[2] * st.j;
}

// K12: the pair's seven columns at every point, added to the per-warp sums:
// K9's draw (draw_steps) and, at each expiry, each path's close split at
// the strike (hh::close_group once, hh::close_partials per strike:
// cond_bs_partials's bits, so the surface column is K9's).
template <bool kSplit, int kQmc>
__device__ __forceinline__ void jac_pair(unsigned long long pair, bool live, const int* sobol,
                                         const uint32_t* hw, int c, uint32_t seed,
                                         uint32_t device_id, long long point_offset, float v0,
                                         const hh::SurfSeg* segs, const hh::CloseParams* close,
                                         const float (*dct)[4], const float (*djt)[3],
                                         const int* nsteps, int n_exp, int m, double* wacc,
                                         int n_cols) {
  SurfTan s, sa;
  tan_init_surface(s, v0);
  tan_init_surface(sa, v0);
  const uint32_t idx = (uint32_t)(point_offset + (long long)pair);
  float z_odd = 0.0f;
  uint32_t w_odd = 0u;
  int step = 0;
  for (int i = 0; i < n_exp; ++i) {
    const hh::SurfSeg& sc = segs[i];
    const float (*dc)[4] = dct + kDirs * i;
    const int end = step + nsteps[i];
    if (live) {
      draw_segment<kQmc, kSplit>(pair, idx, sobol, hw, c, seed, device_id, step, end, z_odd,
                                 w_odd, [&](float z, float u) {
                                   tan_step_surface(s, z, u, sc, dc);
                                   tan_step_surface(sa, -z, 1.0f - u, sc, dc);
                                 });
    }
    step = end;
    float dj[kDirs], dja[kDirs];
#pragma unroll
    for (int d = 0; d < kDirs; ++d) {
      dj[d] = surf_dj(s, sc, djt[kDirs * i + d], d);
      dja[d] = surf_dj(sa, sc, djt[kDirs * i + d], d);
    }
    const hh::CloseGroup g = hh::close_group(s.iv, s.j, close[i * m]);
    const hh::CloseGroup ga = hh::close_group(sa.iv, sa.j, close[i * m]);
    for (int k = 0; k < m; ++k) {
      const int p = i * m + k;
      float col[kJacCols] = {};
      if (live) {
        const hh::BsPartials b = hh::close_partials<false>(g, s.iv, s.j, close[p]);
        const hh::BsPartials ba = hh::close_partials<true>(ga, sa.iv, sa.j, close[p]);
        col[0] = b.y + ba.y;
#pragma unroll
        for (int d = 0; d < kDirs; ++d) {
          col[1 + d] = b.y_iv * s.div[d] + b.y_j * dj[d] + ba.y_iv * sa.div[d] + ba.y_j * dja[d];
        }
        col[5] = b.w + ba.w;
        col[6] = b.y_rho + ba.y_rho;
      }
#pragma unroll
      for (int q = 0; q < kJacCols; ++q) hh::warp_accumulate(col[q], wacc, n_cols, p * kJacCols + q);
    }
  }
}

// The grid-stride round is uniform over the block (base), so every lane of
// a warp reaches the shuffles of a round; a lane past the last pair adds 0.
// kStaged: the Sobol' table (and the warps' high words) in shared memory;
// else the table is read from global memory.  kQmc 1 or 0 compiles one
// stream only (K12: the other stream's draw state then holds no registers,
// which took 8% off its QMC surface on an H100, PERF.md); -1 both.
template <bool kJac, bool kStaged, int kQmc = -1>
__device__ __forceinline__ void surface_body(const float* params, const int* nsteps,
                                             const float* dct, const float* djt, const int* sobol,
                                             double* partials, int n_exp, int m, int total_steps,
                                             long long total_pairs, uint32_t seed,
                                             uint32_t device_id, long long point_offset) {
  extern __shared__ __align__(16) char smem[];
  const Layout l = layout(n_exp, m, total_steps, kJac, sobol != nullptr, kStaged);
  stage(params, nsteps, dct, djt, kStaged ? sobol : nullptr, n_exp, m, total_steps, l, smem);
  double* wacc = reinterpret_cast<double*>(smem);
  const hh::SurfSeg* segs = reinterpret_cast<const hh::SurfSeg*>(smem + l.segs);
  const hh::CloseParams* close = reinterpret_cast<const hh::CloseParams*>(smem + l.close);
  const int* ssteps = reinterpret_cast<const int*>(smem + l.steps);
  const int* table = kQmc == 0 ? nullptr
                     : !sobol    ? nullptr
                     : kStaged   ? reinterpret_cast<const int*>(smem + l.sobol)
                                 : sobol;
  if constexpr (kQmc == 1) __builtin_assume(table != nullptr);
  const float v0 = params[0];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long base = (long long)blockIdx.x * blockDim.x; base < total_pairs; base += stride) {
    const long long g = base + threadIdx.x;
    // the warp's points are p0 + lane; this lane's high word is candidate c
    const uint32_t p0 = (uint32_t)(point_offset + base) + (threadIdx.x & ~31u);
    uint32_t* hw =
        reinterpret_cast<uint32_t*>(smem + l.high) + (threadIdx.x >> 5) * 4 * total_steps;
    if (kStaged && table) stage_high(table, 2 * total_steps, p0, hw);
    const int c = (int)(((p0 & 31u) + (threadIdx.x & 31u)) >> 5);
    if constexpr (kJac) {
      jac_pair<kStaged, kQmc>((unsigned long long)g, g < total_pairs, table, hw, c, seed,
                              device_id, point_offset, v0, segs, close,
                              reinterpret_cast<const float(*)[4]>(smem + l.dct),
                              reinterpret_cast<const float(*)[3]>(smem + l.djt), ssteps, n_exp, m,
                              wacc, l.n_cols);
    } else {
      price_pair<kStaged, kQmc>((unsigned long long)g, g < total_pairs, table, hw, c, seed,
                                device_id, point_offset, v0, segs, close, ssteps, n_exp, m, wacc,
                                l.n_cols);
    }
  }
  hh::block_columns(wacc, l.n_cols, partials);
}

// K9.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
surface_kernel(const float* __restrict__ params, const int* __restrict__ nsteps,
               const int* __restrict__ sobol, double* __restrict__ partials, int n_exp, int m,
               int total_steps, long long total_pairs, uint32_t seed, uint32_t device_id,
               long long point_offset) {
  surface_body<false, kStaged>(params, nsteps, nullptr, nullptr, sobol, partials, n_exp, m,
                               total_steps, total_pairs, seed, device_id, point_offset);
}

// K12, one body per stream.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads, kJacBlocks)
surface_jac_kernel(const float* __restrict__ params, const int* __restrict__ nsteps,
                   const float* __restrict__ dct, const float* __restrict__ djt,
                   const int* __restrict__ sobol, double* __restrict__ partials, int n_exp, int m,
                   int total_steps, long long total_pairs, uint32_t seed, uint32_t device_id,
                   long long point_offset) {
  if (sobol) {
    surface_body<true, kStaged, 1>(params, nsteps, dct, djt, sobol, partials, n_exp, m,
                                   total_steps, total_pairs, seed, device_id, point_offset);
  } else {
    surface_body<true, kStaged, 0>(params, nsteps, dct, djt, sobol, partials, n_exp, m,
                                   total_steps, total_pairs, seed, device_id, point_offset);
  }
}

__global__ void __launch_bounds__(kThreads)
column_sums_kernel(const double* __restrict__ partials, int grid, double* __restrict__ out) {
  __shared__ double red[kThreads];
  const double* row = partials + (long long)blockIdx.x * grid;
  double s = 0.0;
  for (int b = threadIdx.x; b < grid; b += kThreads) s += row[b];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = red[0];
}

// The kernel (K9 or K12), staged or not, that a launch runs, with its
// layout.  The caller decides whether the table is staged and chunks the
// strikes to fit (ops/heston_qe_kernel.py surface_staged, strike_chunks); a
// staged layout larger than a block may take fails the launch.
struct SurfaceLaunch {
  const void* kernel;
  Layout l;
};

SurfaceLaunch surface_launch(bool jac, int n_exp, int m, int total_steps, bool qmc, bool staged) {
  const void* kernel = jac ? (staged ? (const void*)surface_jac_kernel<true>
                                     : (const void*)surface_jac_kernel<false>)
                           : (staged ? (const void*)surface_kernel<true>
                                     : (const void*)surface_kernel<false>);
  return {kernel, layout(n_exp, m, total_steps, jac, qmc, staged)};
}

int launch_surface(bool jac, const float* params, const int* nsteps, const float* dct,
                   const float* djt, const int* sobol, double* partials, double* out, int grid,
                   int n_exp, int m, int total_steps, long long total_pairs, unsigned seed,
                   unsigned device_id, long long point_offset, bool staged, void* stream) {
  const SurfaceLaunch s = surface_launch(jac, n_exp, m, total_steps, sobol != nullptr, staged);
  cudaError_t err = cudaFuncSetAttribute(s.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)s.l.bytes);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  if (s.kernel == (const void*)surface_kernel<true>) {
    surface_kernel<true><<<grid, kThreads, s.l.bytes, st>>>(
        params, nsteps, sobol, partials, n_exp, m, total_steps, total_pairs, seed, device_id,
        point_offset);
  } else if (s.kernel == (const void*)surface_kernel<false>) {
    surface_kernel<false><<<grid, kThreads, s.l.bytes, st>>>(
        params, nsteps, sobol, partials, n_exp, m, total_steps, total_pairs, seed, device_id,
        point_offset);
  } else if (s.kernel == (const void*)surface_jac_kernel<true>) {
    surface_jac_kernel<true><<<grid, kThreads, s.l.bytes, st>>>(
        params, nsteps, dct, djt, sobol, partials, n_exp, m, total_steps, total_pairs, seed,
        device_id, point_offset);
  } else {
    surface_jac_kernel<false><<<grid, kThreads, s.l.bytes, st>>>(
        params, nsteps, dct, djt, sobol, partials, n_exp, m, total_steps, total_pairs, seed,
        device_id, point_offset);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return hh::launch_column_sums(partials, s.l.n_cols, grid, out, st);
}

}  // namespace

int hh::launch_column_sums(const double* partials, int n_cols, int grid, double* out,
                           cudaStream_t stream) {
  column_sums_kernel<<<n_cols, kThreads, 0, stream>>>(partials, grid, out);
  return (int)cudaGetLastError();
}

// K9: out[n_exp * m] float64 sums over the pairs [0, total_pairs) of each
// point's (value + antithetic value), point-major; partials is (n_exp * m,
// grid) scratch.  nsteps[n_exp] int32; sobol the (2 * total_steps, 31)
// table for QMC or null for Philox, staged in shared memory where `staged`
// (else read from global memory).
extern "C" int hh_qe_surface(const float* params, const int* nsteps, const int* sobol,
                             double* partials, double* out, int grid, int n_exp, int m,
                             int total_steps, long long total_pairs, unsigned seed,
                             unsigned device_id, long long point_offset, int staged,
                             void* stream) {
  return launch_surface(false, params, nsteps, nullptr, nullptr, sobol, partials, out, grid,
                        n_exp, m, total_steps, total_pairs, seed, device_id, point_offset,
                        staged != 0, stream);
}

// K12: out[n_exp * m * 7] float64 sums of each point's seven columns; dct
// (4 * n_exp, 4) and djt (4 * n_exp, 3) float32 tangent rows.
extern "C" int hh_qe_surface_jacobian(const float* params, const int* nsteps, const float* dct,
                                      const float* djt, const int* sobol, double* partials,
                                      double* out, int grid, int n_exp, int m, int total_steps,
                                      long long total_pairs, unsigned seed, unsigned device_id,
                                      long long point_offset, int staged, void* stream) {
  return launch_surface(true, params, nsteps, dct, djt, sobol, partials, out, grid, n_exp, m,
                        total_steps, total_pairs, seed, device_id, point_offset, staged != 0,
                        stream);
}

// The grid of K9 and K12 on the current device: SMs x lcm(resident blocks
// per SM of K9, of K12), so each runs whole waves and both walk the pairs
// alike.  Occupancy is taken without dynamic shared memory (the register
// limit): the grid does not depend on the surface's shape.
extern "C" int hh_surface_grid(int* grid) {
  int dev = 0, sms = 0, per_price = 0, per_jac = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_price, surface_kernel<true>,
                                                        kThreads, 0);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_jac, surface_jac_kernel<true>,
                                                        kThreads, 0);
  }
  *grid = sms * std::lcm(per_price > 0 ? per_price : 1, per_jac > 0 ? per_jac : 1);
  return (int)err;
}

// The occupancy of K9 (jac = 0) or K12 (jac = 1) on the current device at
// one launch's shared memory, the table staged or not: out = (threads a
// block, resident blocks per SM, SMs, dynamic shared bytes, static shared
// bytes, registers a thread, local (spill) bytes a thread).
extern "C" int hh_surface_occupancy(int jac, int n_exp, int m, int total_steps, int qmc,
                                    int staged, int* out) {
  const SurfaceLaunch s = surface_launch(jac != 0, n_exp, m, total_steps, qmc != 0, staged != 0);
  int dev = 0, sms = 0, per_sm = 0;
  cudaFuncAttributes attr{};
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(s.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)s.l.bytes);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, s.kernel, kThreads, s.l.bytes);
  }
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, s.kernel);
  const int vals[7] = {kThreads, per_sm, sms, (int)s.l.bytes, (int)attr.sharedSizeBytes,
                       attr.numRegs, (int)attr.localSizeBytes};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return (int)err;
}
