// Rough-Bergomi mixing kernels for sm_90a: per-path values (K14), the
// accumulating serving price (K15), the price + 6-greek vector (K16), the
// cotangent-weighted VJP of the values (K17), its per-step variant under a
// forward-variance curve (K18) and the one-simulation smile (K19).
//
// Replaces hedgehog_tpu/ops/rbergomi_kernel.py:
//   rbergomi_mixing_values           (pallas_call at :273 QMC, :288 PRNG;
//                                     bodies _rb_values_kernel[_qmc])
//   rbergomi_mixing_vanilla_price    (pallas_call at :371 QMC, :386 PRNG;
//                                     bodies _rb_price_kernel[_qmc])
//   rbergomi_mixing_price_and_greeks (pallas_call at :673 QMC, :695 PRNG;
//                                     bodies _rb_greeks_kernel[_qmc])
//   _rb_values_vjp                   (pallas_call at :992 QMC, :1015 PRNG;
//                                     bodies _rb_weighted_kernel[_qmc])
//   _rb_values_vjp_curve             (pallas_call at :1191 QMC, :1215 PRNG;
//                                     the same bodies with per_step=True)
//   rbergomi_mixing_smile_price      (pallas_call at :1452 QMC, :1474 PRNG;
//                                     bodies _rb_smile_kernel[_qmc])
// The plain PyTorch twins are in hedgehog_tpu_torch/ops/rbergomi_kernel.py;
// keep the two in step.
//
// Per pair: 2n standard normals xi (ops/rbergomi_kernel.py: Philox block b ->
// rows 4b..4b+3 through hh::box_muller_open, or Sobol' dims 0..2n-1 through
// hh::sobol_normal, which never sees u = 1.0), the
// Volterra product X = L xi, the left-point sums IV = dt (C_0 + sum_k C_k
// e^{eta Z_k}) and J = sum_k sqrt(C_k e^{eta Z_k}) dW_k of both antithetic
// groups (the mirror's variance through rcp of the + group's exponentials:
// X(-xi) = -X), then the conditional Black-Scholes close.  K16 and K17 carry
// forward tangents in (xi0, eta, H) beside it, H through a second product
// Xd = (dL/dH) xi.
//
// What bounds them on this card: operations, not memory (K14 writes 8 bytes
// a pair, K15/K16 a few doubles per block, K17 reads the 8-byte cotangent of
// a pair).  By the factor's structure (the ΔW block is diagonal; the Z row
// at t_{j+1} weighs increments 0..j and Z columns 0..j) the product costs
// n(n-1) FMAs a pair, about 4K at n = 64, against the TPU kernel's dense
// (2n)^2 on a 128-padded tile; a step adds two exponentials' worth of MUFU
// (ex2, rsqrt, two rcp) and a dozen FLOPs, and the Philox or Sobol' draw of
// 2n normals comes on top.  On an H100 K14 and K17 run 7-10x above that
// operation bound, K15 5x and K18 5.5x (PERF.md): latency-bound chains at few
// warps an SM, not the issue rate of any one pipe.
//
// K14 and K17: one antithetic pair per thread (rb_walk).  The thread
// draws its xi column into shared memory (row-major, one float per thread a
// row: conflict-free), then walks the consumed Z rows in tiles of kTile rows
// whose kTile accumulators live in registers: for each column one shared
// load of each xi it multiplies and warp-uniform float4 loads of the
// factor's packed entries (6 loads per 16 FMAs, each factor value feeding
// one pair).  Step k consumes Z row k-1 and dW_k as soon as its tile is
// done, so the state is O(1) a path.  The step limit (ops/rbergomi_kernel.py
// MAX_STEPS) comes from the xi column (2n rows padded to whole tiles) and
// the Sobol' table in shared memory.  The primal sums round each product and
// sum separately (__fmul_rn/__fadd_rn, as the twins do) and the product uses
// explicit fmaf in one order, so every kernel computes a pair's values to
// the same bits.
//
// K15 and K19: the block-cooperative product over row chunks.  A block of
// 128 threads takes 64 consecutive pairs a trip: the threads draw the 64 xi
// columns (two a column), then for each chunk of 32 Z rows every warp forms
// one tile's rows for all 64 pairs, a lane 4 pairs x 4 rows in registers
// (one LDS.128 of each xi and two warp-uniform LDG.128 of the factor per
// column: 4 loads per 32 FMAs, each factor value feeding 4 pairs), into an
// 8 KB chunk buffer; after a barrier each thread walks one antithetic group
// of one pair through the chunk's steps (the mirror's thread takes rcp of
// the exponentials it recomputes).  A row still sums its columns in
// rb_walk's order with rb_walk's fmaf, and a step rounds as rb_step, so each
// pair's (IV, J) keeps its bits; the whole X is never held (at 256 steps
// under QMC the xi columns and the Sobol' table take 192 KB).  Slot t of a
// trip walks the pairs one thread would (blockIdx.x * 64 + t + trip * grid
// * 64) and the 64 slot sums reduce by block_sums's tree, and K16 walks
// K15's trips on K15's grid (one resident wave of K15 and of K16), so
// K16's price is K15's to the bit.  Measured (PERF.md, H100): 5 blocks (20
// warps) an SM on PRNG, 4 (16) under QMC, against 6 (12) and 4 (8) one
// pair a thread; 64 registers; K15 1.6x and K19 1.3x faster than one pair
// a thread.  What is left, each phase's marginal share of K15 at 2^24
// pairs (PRNG / QMC): the walk 32 / 26%, the product 29 / 16%, the draw
// 10 / 38%.  The Sobol' table read through L1 instead of staged was slower
// (QMC K15 39.7 against 28.7 ms at 2^24 pairs); 16-row chunks (6 blocks an
// SM, one pair a thread's grid) matched K15 but left K19, 5 resident of 6,
// no faster.  K16 on the tangent chunk product (16-row chunks, K15's 40.5 /
// 56 KB and blocks an SM) is 1.84x faster on Philox and 1.26x under QMC
// than one pair a thread; under QMC its draw, most of it ndtri_approx's two
// branches in every warp, is a third of its time.
//
// K18 (the backward of the values under a ForwardVarianceCurve) adds one row
// per step, R_k = ct (y_IV dt P_k + y_J/2 s_k dW_k) = d(ct value)/d ln C_k,
// whose weights y_IV and y_J are known only after the close.  Keeping each
// pair's Z (or P_k and s_k dW_k) through the product would cost another n
// floats a pair of shared memory (64 KB more a block at 256 steps, over
// the 227 KB limit with the xi columns and the Sobol' table), so K18 replays
// the L product once the close is done: the same fp32 operations, so the
// same P_k and s_k dW_k bits, for one more n(n-1) FMAs a pair.  It runs on
// the block-cooperative product (below): a block of 128 threads takes one
// trip of 64 pairs, forms Z and its H tangent Zd = (dL/dH) xi chunk by chunk
// (rb_trip_tangents: two chunk_products, one over dpack, then each thread's
// group through rb_step's tangent operations), closes each group on its own
// thread, and the + thread of a slot takes the mirror's rows by shuffles to
// form the pair's six scalar chains and, over the replay, its R_k in the
// expressions of one pair a thread.  R_k is summed over the 64 slots in
// float64 as two 32-slot butterflies added in order (one pair a thread's
// two warps) into (n + 6, blocks) float64 partials, the chains by
// block_sums<64>'s tree, so K18's sums keep the bits of one pair a thread's
// (its 64-thread blocks, the same pairs a block).  Measured (PERF.md, H100):
// 1.37x faster on Philox, 1.72x under QMC at 64 steps.
//
// K19 (one path set closing m strikes) walks K15's pairs with K15's grid and
// closes each strike with the operations of hh::cond_bs_close in their
// order, split at the strike (hh::close_group once per group, then
// hh::close_value per strike), so each
// strike's price equals K15's at that strike to the bit.  Unlike the TPU
// kernel it takes log(f_base/K) cast once from float64 (the TPU wrapper forms
// it in float32) and forms d1 as (log(f/K) + e_arg + var/2)/sd, K15's order
// (the TPU kernel adds log(f/K)/sd last).  The m fp32 accumulators of a
// thread live in shared memory beside the xi column (one float a thread a
// strike, conflict-free), so m costs no registers: at most kMaxStrikes.

#include "heston_qe.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kTile = 8;
constexpr int kGreekCols = 6;  // y, chain_xi0, chain_eta, chain_H, w, y_rho
constexpr int kVjpCols = 7;    // chain_xi0, chain_eta, chain_H, chain_T, w, y_rho, y_K
constexpr int kCurveCols = 6;  // K18's scalar rows: kVjpCols without chain_xi0
constexpr int kMaxStrikes = 64;

// Field order is ops/rbergomi_kernel.py RB_NAMES.
struct RbParams {
  float eta, dt;
  hh::CloseParams close;
  float inv_xi0, h_eta, inv_t;
};
static_assert(sizeof(RbParams) == 12 * sizeof(float), "rough-Bergomi parameter layout");

// One step's coefficients: two float4 (C_k, sqrt C_k, L[k][k], dL[k][k]/dH)
// and (ae_k, bh_k, 0, 0).
struct RbShape {
  int n, tiles, zcols, xi_rows;
};

__host__ __device__ inline RbShape rb_shape(int n) {
  RbShape s;
  s.n = n;
  s.tiles = (n - 1 + kTile - 1) / kTile;
  s.zcols = s.tiles * kTile;
  s.xi_rows = n + s.zcols;
  return s;
}

// The 4-byte words of the Sobol' table, staged after the xi column.
__host__ __device__ inline int table_words(int steps, bool qmc) {
  return qmc ? 2 * steps * (hh::kSobolBits + 1) : 0;
}

// Dynamic shared memory of K14-K17 (K18 and K19 add theirs after it).
size_t rb_smem(int steps, bool qmc) {
  const RbShape s = rb_shape(steps);
  return sizeof(float) * ((size_t)s.xi_rows * kThreads + table_words(steps, qmc));
}

// The Sobol' table into shared memory after the xi columns; returns it (or
// null for the Philox stream).
__device__ __forceinline__ const int* stage_table(const int* sobol, int n, int* ssob) {
  if (sobol) {
    const int count = 2 * n * (hh::kSobolBits + 1);
    for (int i = threadIdx.x; i < count; i += blockDim.x) ssob[i] = sobol[i];
  }
  __syncthreads();
  return sobol ? ssob : nullptr;
}

// The xi column of global pair `pair` into xs[r * kThreads + t]: rows
// 0..2n-2 drawn (row 2n-1 feeds no consumed row), the rest up to xi_rows
// zero.  With `parts` > 1 the caller draws only its share: every parts-th
// Sobol' row, Philox block and zero row from its `part`-th.
// Each value depends on (pair, row) alone, so the split keeps its bits.
// kSplit (the caller's warp holds 32 consecutive pairs and one `part`)
// forms each Sobol' integer split at bit 5: a row's high word is one of
// two warp-uniform candidates (hh::sobol_high), lane j forming those of
// the warp's j-th row of each 32 and passing them by shuffles, and each
// point XORs in hh::sobol_low; the integers, so the normals, are the
// unsplit ones.
template <bool kSplit = false>
__device__ __forceinline__ void draw_xi(float* xs, unsigned long long pair, const int* sobol,
                                        const RbShape& s, uint32_t seed, uint32_t device_id,
                                        long long point_offset, int t, int part = 0,
                                        int parts = 1) {
  const int rows = 2 * s.n - 1;
  if (sobol) {
    const uint32_t idx = (uint32_t)(point_offset + (long long)pair);
    if constexpr (kSplit) {
      const int lane = threadIdx.x & 31;
      const uint32_t p0 = idx - (uint32_t)lane, lo = p0 & ~31u;  // the warp's first point
      const bool c = (((p0 & 31u) + (uint32_t)lane) >> 5) != 0u;
      for (int r0 = part; r0 < rows; r0 += 32 * parts) {
        const int rj = r0 + lane * parts;
        uint32_t h0 = 0u, h1 = 0u;
        if (rj < rows) {
          h0 = hh::sobol_high(lo, sobol + rj * (hh::kSobolBits + 1));
          h1 = hh::sobol_high(lo + 32u, sobol + rj * (hh::kSobolBits + 1));
        }
        const int count = min(32, (rows - r0 + parts - 1) / parts);
        for (int k = 0; k < count; ++k) {
          const int r = r0 + k * parts;
          const uint32_t a0 = __shfl_sync(0xffffffffu, h0, k);
          const uint32_t a1 = __shfl_sync(0xffffffffu, h1, k);
          const uint32_t a = (c ? a1 : a0) ^ hh::sobol_low(idx, sobol + r * (hh::kSobolBits + 1));
          xs[r * kThreads + t] = hh::sobol_normal_of(a);
        }
      }
    } else {
      for (int r = part; r < rows; r += parts) {
        xs[r * kThreads + t] = hh::sobol_normal(idx, sobol + r * (hh::kSobolBits + 1));
      }
    }
  } else {
    for (int b = part; 4 * b < rows; b += parts) {
      const hh::U4 w = hh::philox_block(pair, (uint32_t)b, seed, device_id);
      float z[4];
      hh::box_muller_open(w.x, w.y, z[0], z[1]);
      hh::box_muller_open(w.z, w.w, z[2], z[3]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (4 * b + q < rows) xs[(4 * b + q) * kThreads + t] = z[q];
      }
    }
  }
  for (int r = rows + part; r < s.xi_rows; r += parts) xs[r * kThreads + t] = 0.0f;
}

// One antithetic group's running sums: the primal (sum C_k e, sum s_k dW_k)
// and the tangent sums of the greek kernels.
struct Group {
  float iv, j;
  float div_eta, dj_eta, div_h, djh_g, djh_s;
};

// Tangent sums of one group at one step: p = C e, s = sqrt(C e), sdw = s dW,
// with the group's signed z, zd = dZ/dH and dwd = d(dW)/dH.
__device__ __forceinline__ void tangent_step(Group& g, float p, float s, float sdw, float z,
                                             float zd, float dwd, float ae, float bh, float eta) {
  const float a = z + ae;             // d ln P_k / d eta
  const float gh = fmaf(eta, zd, bh);  // d ln P_k / d H
  g.div_eta = fmaf(p, a, g.div_eta);
  g.dj_eta = fmaf(a, sdw, g.dj_eta);
  g.div_h = fmaf(p, gh, g.div_h);
  g.djh_g = fmaf(gh, sdw, g.djh_g);
  g.djh_s = fmaf(s, dwd, g.djh_s);
}

// 2 * kTile packed entries of the factor at (tile, column): kTile of the
// increments' block then kTile of the Z block, as four float4.
__device__ __forceinline__ void load_col(const float4* __restrict__ pack, int idx, float* v) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 f = __ldg(pack + 4 * idx + q);
    v[4 * q] = f.x;
    v[4 * q + 1] = f.y;
    v[4 * q + 2] = f.z;
    v[4 * q + 3] = f.w;
  }
}

// Adds column c's terms to the tile's accumulators, rows r >= first.
template <int kFirst>
__device__ __forceinline__ void add_col(const float* v, float xa, float xb, float* acc) {
#pragma unroll
  for (int r = kFirst; r < kTile; ++r) {
    acc[r] = fmaf(v[r], xa, acc[r]);
    acc[r] = fmaf(v[kTile + r], xb, acc[r]);
  }
}

template <int kCC, bool kTan>
__device__ __forceinline__ void triangle_col(const float* xs, const float4* lpack,
                                             const float4* dpack, const RbShape& s, int tile,
                                             float* acc, float* accd) {
  const int t = threadIdx.x;
  const int c = tile * kTile + kCC;
  const float xa = xs[c * kThreads + t], xb = xs[(s.n + c) * kThreads + t];
  float v[2 * kTile];
  load_col(lpack, tile * s.zcols + c, v);
  add_col<kCC>(v, xa, xb, acc);
  if (kTan) {
    load_col(dpack, tile * s.zcols + c, v);
    add_col<kCC>(v, xa, xb, accd);
  }
}

// Step k's primal terms of both groups from Z_{t_k} = z: P = C_k e^{eta z},
// s = sqrt(P) and s dW_k (the mirror's from rcp of the + group's
// exponentials, its s dW unsigned), each product rounded on its own.
struct StepTerms {
  float xk, pp, sp, sdw_p, pm, sm, sdw_m;
};

__device__ __forceinline__ StepTerms step_terms(const float* xs, const RbParams& p,
                                                const float4& ck, int k, float z, bool anti) {
  StepTerms o;
  o.xk = xs[k * kThreads + threadIdx.x];
  const float dw = __fmul_rn(ck.z, o.xk);
  const float ep = expf(__fmul_rn(p.eta, z));
  const float sep = sqrtf(ep);
  o.pp = __fmul_rn(ck.x, ep);
  o.sp = __fmul_rn(ck.y, sep);
  o.sdw_p = __fmul_rn(o.sp, dw);
  o.pm = o.sm = o.sdw_m = 0.0f;
  if (anti) {
    o.pm = __fmul_rn(ck.x, hh::rcp(ep));
    o.sm = __fmul_rn(ck.y, hh::rcp(sep));
    o.sdw_m = __fmul_rn(o.sm, dw);
  }
  return o;
}

// Step k (1 <= k < n) of both groups from Z_{t_k} = z (and its H tangent
// zd): the left-point sums with each sum rounded on its own; the tangent
// sums when kTan.
template <bool kTan>
__device__ __forceinline__ void rb_step(const float* xs, const RbParams& p,
                                        const float4* __restrict__ coef, int k, float z, float zd,
                                        bool anti, Group& gp, Group& gm) {
  const float4 ck = __ldg(coef + 2 * k);
  const StepTerms st = step_terms(xs, p, ck, k, z, anti);
  gp.iv = __fadd_rn(gp.iv, st.pp);
  gp.j = __fadd_rn(gp.j, st.sdw_p);
  if (anti) {
    gm.iv = __fadd_rn(gm.iv, st.pm);
    gm.j = __fadd_rn(gm.j, st.sdw_m);
  }
  if (kTan) {
    const float4 ck2 = __ldg(coef + 2 * k + 1);
    const float dwd = __fmul_rn(ck.w, st.xk);
    tangent_step(gp, st.pp, st.sp, st.sdw_p, z, zd, dwd, ck2.x, ck2.y, p.eta);
    if (anti) tangent_step(gm, st.pm, st.sm, -st.sdw_m, -z, -zd, -dwd, ck2.x, ck2.y, p.eta);
  }
}

// The Volterra product of the pair's xi column in tiles: f(k, Z_{t_k}, its H
// tangent) for each step k = 1..n-1, in order, as Z row k-1's tile is done.
template <bool kTan, class F>
__device__ __forceinline__ void rb_walk(const float* xs, const float4* __restrict__ lpack,
                                        const float4* __restrict__ dpack, const RbShape& s,
                                        F&& f) {
  const int t = threadIdx.x;
  for (int tile = 0; tile < s.tiles; ++tile) {
    float acc[kTile], accd[kTile];
#pragma unroll
    for (int r = 0; r < kTile; ++r) acc[r] = accd[r] = 0.0f;
    const int j0 = tile * kTile;
    for (int c = 0; c < j0; ++c) {
      const float xa = xs[c * kThreads + t], xb = xs[(s.n + c) * kThreads + t];
      float v[2 * kTile];
      load_col(lpack, tile * s.zcols + c, v);
      add_col<0>(v, xa, xb, acc);
      if (kTan) {
        load_col(dpack, tile * s.zcols + c, v);
        add_col<0>(v, xa, xb, accd);
      }
    }
    triangle_col<0, kTan>(xs, lpack, dpack, s, tile, acc, accd);
    triangle_col<1, kTan>(xs, lpack, dpack, s, tile, acc, accd);
    triangle_col<2, kTan>(xs, lpack, dpack, s, tile, acc, accd);
    triangle_col<3, kTan>(xs, lpack, dpack, s, tile, acc, accd);
    triangle_col<4, kTan>(xs, lpack, dpack, s, tile, acc, accd);
    triangle_col<5, kTan>(xs, lpack, dpack, s, tile, acc, accd);
    triangle_col<6, kTan>(xs, lpack, dpack, s, tile, acc, accd);
    triangle_col<7, kTan>(xs, lpack, dpack, s, tile, acc, accd);
    static_assert(kTile == 8, "one triangle_col per tile row");
#pragma unroll
    for (int r = 0; r < kTile; ++r) {
      const int k = j0 + r + 1;  // step k consumes Z_{t_k} = Z row k - 1 and dW_k
      if (k < s.n) f(k, acc[r], accd[r]);
    }
  }
}

// The pair's two groups over all steps from its xi column, each step consumed
// as its Z row is done.  dw0 (and dwd0) return the first increment (and its
// H tangent).
template <bool kTan>
__device__ __forceinline__ void rb_groups(const float* xs, const RbParams& p,
                                          const float4* __restrict__ coef,
                                          const float4* __restrict__ lpack,
                                          const float4* __restrict__ dpack, const RbShape& s,
                                          bool anti, float& dw0, float& dwd0, Group& gp,
                                          Group& gm) {
  const float4 c0 = __ldg(coef);
  dw0 = __fmul_rn(c0.z, xs[threadIdx.x]);
  dwd0 = kTan ? __fmul_rn(c0.w, xs[threadIdx.x]) : 0.0f;
  gp = Group{};
  gm = Group{};
  rb_walk<kTan>(xs, lpack, dpack, s, [&](int k, float z, float zd) {
    rb_step<kTan>(xs, p, coef, k, z, zd, anti, gp, gm);
  });
}

// The groups' (IV, J): IV = dt (C_0 + sum), J = +-(sqrt(C_0) dW_0) +- sum.
__device__ __forceinline__ void close_factors(const Group& g, bool mirror, float c0, float s0dw0,
                                              float dt, float& iv, float& j) {
  iv = __fmul_rn(dt, __fadd_rn(c0, g.iv));
  j = mirror ? __fsub_rn(-s0dw0, g.j) : __fadd_rn(s0dw0, g.j);
}

// The tangent rows of one group (greeks: 6; the VJP: 7, with chain_T and
// y_K, without y) from its (IV, J) and sums; `s0dwd0` is the group's
// signed sqrt(C_0) dWd_0.  Returns the close's partials.
template <bool kVjp>
__device__ __forceinline__ hh::BsPartials group_rows(const Group& g, float iv, float j,
                                                     float s0dwd0, const RbParams& p,
                                                     float* rows) {
  const float div_eta = p.dt * g.div_eta;
  const float dj_eta = 0.5f * g.dj_eta;
  const float div_h = p.dt * g.div_h;
  const float dj_h = 0.5f * g.djh_g + s0dwd0 + g.djh_s;
  const hh::BsPartials b = hh::cond_bs_partials(iv, j, p.close);
  const float ch_xi0 = (b.y_iv * iv + b.y_j * 0.5f * j) * p.inv_xi0;
  const float ch_eta = b.y_iv * div_eta + b.y_j * dj_eta;
  const float ch_h = b.y_iv * div_h + b.y_j * dj_h;
  if (!kVjp) {
    rows[0] = b.y;
    // chain_xi0 before its 1/xi0 scale: add_pair_rows scales and adds the
    // two groups' in one FMA, as one pair a thread's close contracted them
    rows[1] = __fmaf_rn(b.y_j * 0.5f, j, __fmul_rn(b.y_iv, iv));
    rows[2] = ch_eta;
    rows[3] = ch_h;
    rows[4] = b.w;
    rows[5] = b.y_rho;
    return b;
  }
  const float div_t = p.inv_t * (iv + p.h_eta * div_eta);
  const float dj_t = p.inv_t * (p.h_eta * dj_eta + 0.5f * j);
  rows[0] = ch_xi0;
  rows[1] = ch_eta;
  rows[2] = ch_h;
  rows[3] = b.y_iv * div_t + b.y_j * dj_t;
  rows[4] = b.w;
  rows[5] = b.y_rho;
  rows[6] = -p.close.cp * b.phi2;
  return b;
}

// The (value, antithetic value) of global pair `pair` (K14); the
// antithetic value is 0 unless `anti`.
__device__ __forceinline__ void rb_pair_values(float* xs, unsigned long long pair,
                                               const RbParams& p, const float4* coef,
                                               const float4* lpack, const int* table,
                                               const RbShape& s, bool anti, uint32_t seed,
                                               uint32_t device_id, long long point_offset,
                                               float& val, float& val_a) {
  draw_xi(xs, pair, table, s, seed, device_id, point_offset, threadIdx.x);
  float dw0, dwd0;
  Group gp, gm;
  rb_groups<false>(xs, p, coef, lpack, nullptr, s, anti, dw0, dwd0, gp, gm);
  const float4 c0 = __ldg(coef);
  const float s0dw0 = __fmul_rn(c0.y, dw0);
  float iv, j;
  close_factors(gp, false, c0.x, s0dw0, p.dt, iv, j);
  val = hh::cond_bs_value(iv, j, p.close);
  val_a = 0.0f;
  if (anti) {
    close_factors(gm, true, c0.x, s0dw0, p.dt, iv, j);
    val_a = hh::cond_bs_value(iv, j, p.close);
  }
}

// One pair's close in one thread: each group's tangent rows (group_rows on
// close_factors) from its sums, weighted by ct_p and ct_m (K16: 1, 1; K17:
// the pair's cotangents) and added into acc where `add`.  dw0 and dwd0 are
// the pair's first increment and its H tangent.  K16 and K17 close through
// this one function, so their rows have one pair a thread's bits.
template <bool kVjp, int kCols>
__device__ __forceinline__ void add_pair_rows(const Group& gp, const Group& gm, bool anti,
                                              float dw0, float dwd0, const float4& c0,
                                              const RbParams& p, float ct_p, float ct_m, bool add,
                                              float* acc) {
  const float s0dw0 = __fmul_rn(c0.y, dw0);
  const float s0dwd0 = c0.y * dwd0;
  float iv, j, rp[kCols], rm[kCols] = {};
  close_factors(gp, false, c0.x, s0dw0, p.dt, iv, j);
  group_rows<kVjp>(gp, iv, j, s0dwd0, p, rp);
  if (anti) {
    close_factors(gm, true, c0.x, s0dw0, p.dt, iv, j);
    group_rows<kVjp>(gm, iv, j, -s0dwd0, p, rm);
  }
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    if (!add) continue;
    if (kVjp) {
      acc[k] += anti ? ct_p * rp[k] + ct_m * rm[k] : ct_p * rp[k];
    } else if (k == 1) {
      acc[k] += __fmaf_rn(p.inv_xi0, rp[k], __fmul_rn(p.inv_xi0, rm[k]));
    } else {
      acc[k] += rp[k] + rm[k];  // as K15 adds value + antithetic value
    }
  }
}

// K17's rows of global pair `pair` (one pair a thread), weighted by the
// pair's cotangents ct_p and ct_m and added into acc.
template <int kCols>
__device__ __forceinline__ void rb_pair_rows(float* xs, unsigned long long pair, const RbParams& p,
                                             const float4* coef, const float4* lpack,
                                             const float4* dpack, const int* table,
                                             const RbShape& s, bool anti, uint32_t seed,
                                             uint32_t device_id, long long point_offset,
                                             float ct_p, float ct_m, float* acc) {
  draw_xi(xs, pair, table, s, seed, device_id, point_offset, threadIdx.x);
  float dw0, dwd0;
  Group gp, gm;
  rb_groups<true>(xs, p, coef, lpack, dpack, s, anti, dw0, dwd0, gp, gm);
  add_pair_rows<true, kCols>(gp, gm, anti, dw0, dwd0, __ldg(coef), p, ct_p, ct_m, true, acc);
}

// The float64 sum of x over the warp, the same bits in every lane (a
// butterfly).
__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---- K15 and K19: the block-cooperative product over row chunks -----------
//
// A block of kChunkThreads threads takes kThreads consecutive pairs a trip
// (slot t of the trip at `base` is pair base + t, so slot t walks the pairs
// one thread a pair would: blockIdx.x * 64 + t + trip * gridDim.x * 64).

constexpr int kChunkThreads = 128;
constexpr int kChunkWarps = kChunkThreads / 32;
constexpr int kChunkRows = kChunkWarps * kTile;  // Z rows a chunk: one tile a warp
constexpr int kQuad = 4;                          // pairs of a register tile
constexpr int kHalf = kTile / 2;                  // rows of a register tile
constexpr int kHalfChunkRows = kChunkRows / 2;    // Z rows of a chunk of K16
constexpr int kGreeksBlocks = 5;                  // K16's blocks an SM on Philox at 64 steps
static_assert(kChunkThreads == 2 * kThreads, "the walk takes one antithetic group a thread");
static_assert(kThreads == 16 * kQuad, "a warp is one tile: 16 quads of pairs x 2 half tiles");

// Dynamic shared memory of K15 (K19 adds its strike sums): the xi columns,
// the chunk of Z rows, then the Sobol' table.
size_t rb_chunk_smem(int steps, bool qmc) {
  return rb_smem(steps, qmc) + sizeof(float) * kChunkRows * kThreads;
}

// K16's: the xi columns, the half-height chunks of Z and of its H tangent,
// then the Sobol' table: K15's bytes.
size_t rb_greeks_smem(int steps, bool qmc) {
  return rb_smem(steps, qmc) + sizeof(float) * 2 * kHalfChunkRows * kThreads;
}

// K18's: the xi columns, the chunks of Z and of its H tangent (in the replay
// the rows R_k), then the Sobol' table.
size_t rb_curve_smem(int steps, bool qmc) {
  return rb_chunk_smem(steps, qmc) + sizeof(float) * kChunkRows * kThreads;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Column c's terms of a register tile (kHalf rows x kQuad pairs): the
// increments' entries fa and the Z entries fb of its rows, the pairs' xi_c
// in xa and xi_{n+c} in xb; per output the two FMAs of add_col in its order.
// Rows i < skip are left as they are (the triangle's columns).
__device__ __forceinline__ void quad_col(const float4& fa, const float4& fb, const float4& xa,
                                         const float4& xb, int skip,
                                         float (&acc)[kHalf][kQuad]) {
  const float a[kHalf] = {fa.x, fa.y, fa.z, fa.w}, b[kHalf] = {fb.x, fb.y, fb.z, fb.w};
  const float pa[kQuad] = {xa.x, xa.y, xa.z, xa.w}, pb[kQuad] = {xb.x, xb.y, xb.z, xb.w};
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
#pragma unroll
    for (int q = 0; q < kQuad; ++q) {
      const float v = fmaf(b[i], pb[q], fmaf(a[i], pa[q], acc[i][q]));
      acc[i][q] = i >= skip ? v : acc[i][q];
    }
  }
}

// Z rows [chunk * kTiles * kTile, + kTiles * kTile) of the trip's pairs
// (their H tangent when `pack` is dpack) into buf[(row - chunk * kTiles *
// kTile) * kThreads + slot]: warp w takes tile chunk * kTiles + w % kTiles
// (K15, K18, K19: kTiles = kChunkWarps, a chunk of kChunkRows rows), lane l
// pairs 4 (l % 16)..+3 and the tile's rows 4 (l / 16)..+3.  Each row sums
// columns 0..row as rb_walk's tile does: the packed entries of each column,
// the same fmaf in the same order, so each pair's Z has rb_walk's bits
// whatever the chunk that holds its tile.
template <int kTiles>
__device__ __forceinline__ void chunk_product(const float* xs, const float4* __restrict__ pack,
                                              const RbShape& s, int chunk, float* buf) {
  // w is the warp itself where a chunk holds a tile a warp: K15's, K18's
  // and K19's registers and spills move with how the product is written
  const int w = kTiles == kChunkWarps ? threadIdx.x >> 5 : (threadIdx.x >> 5) % kTiles;
  const int l = threadIdx.x & 31;
  const int tile = chunk * kTiles + w;
  if (tile >= s.tiles) return;
  const int q0 = kQuad * (l & 15), h = l >> 4;
  const int j0 = tile * kTile;
  // float4 (tile, c, quarter): quarters 0-1 the increments' rows, 2-3 Z's
  const float4* col = pack + 4 * (tile * s.zcols) + h;
  float acc[kHalf][kQuad] = {};
#pragma unroll 2
  for (int c = 0; c < j0; ++c) {
    quad_col(__ldg(col + 4 * c), __ldg(col + 4 * c + 2), lds4(xs + c * kThreads + q0),
             lds4(xs + (s.n + c) * kThreads + q0), 0, acc);
  }
  // column j0 + cc feeds the tile's rows r >= cc
#pragma unroll
  for (int cc = 0; cc < kTile; ++cc) {
    const int c = j0 + cc;
    quad_col(__ldg(col + 4 * c), __ldg(col + 4 * c + 2), lds4(xs + c * kThreads + q0),
             lds4(xs + (s.n + c) * kThreads + q0), cc - kHalf * h, acc);
  }
  float* rows = buf + (w * kTile + kHalf * h) * kThreads + q0;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    *reinterpret_cast<float4*>(rows + i * kThreads) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// The chunk's steps of one antithetic group of slot `slot`: the + group, or
// the mirror from rcp of the + group's exponentials; step_terms's operations
// and rounding, each sum in step order.
__device__ __forceinline__ void chunk_walk(const float* xs, const float* xbuf, const RbParams& p,
                                           const float4* __restrict__ coef, const RbShape& s,
                                           int chunk, bool mirror, int slot, Group& g) {
  const int k0 = chunk * kChunkRows + 1;  // step k consumes Z row k - 1 and dW_k
  const int count = min(kChunkRows, s.n - k0);
#pragma unroll 4
  for (int r = 0; r < count; ++r) {
    const int k = k0 + r;
    const float4 ck = __ldg(coef + 2 * k);
    const float dw = __fmul_rn(ck.z, xs[k * kThreads + slot]);
    const float ep = expf(__fmul_rn(p.eta, xbuf[r * kThreads + slot]));
    const float sep = sqrtf(ep);
    const float e = mirror ? hh::rcp(ep) : ep;
    const float se = mirror ? hh::rcp(sep) : sep;
    g.iv = __fadd_rn(g.iv, __fmul_rn(ck.x, e));
    g.j = __fadd_rn(g.j, __fmul_rn(__fmul_rn(ck.y, se), dw));
  }
}

// The (IV, J) of this thread's group of the trip's slot threadIdx.x / 2
// (even threads the + group, odd ones the mirror): the block draws the
// trip's xi columns (two threads a column), then each chunk's product and
// walk.  Every thread of the block calls it: it holds the barriers.
__device__ __forceinline__ void rb_trip_factors(float* xs, float* xbuf, unsigned long long base,
                                                const RbParams& p, const float4* coef,
                                                const float4* lpack, const int* table,
                                                const RbShape& s, uint32_t seed,
                                                uint32_t device_id, long long point_offset,
                                                float& iv, float& j) {
  const int t = threadIdx.x, slot = t >> 1;
  const bool mirror = t & 1;
  __syncthreads();  // the last trip's reads of xs are done
  draw_xi(xs, base + t % kThreads, table, s, seed, device_id, point_offset, t % kThreads,
          t / kThreads, kChunkThreads / kThreads);
  __syncthreads();
  const float x0 = xs[slot];
  Group g{};
  for (int chunk = 0; chunk * kChunkRows < s.n - 1; ++chunk) {
    chunk_product<kChunkWarps>(xs, lpack, s, chunk, xbuf);
    __syncthreads();
    chunk_walk(xs, xbuf, p, coef, s, chunk, mirror, slot, g);
    __syncthreads();
  }
  const float4 c0 = __ldg(coef);
  close_factors(g, mirror, c0.x, __fmul_rn(c0.y, __fmul_rn(c0.z, x0)), p.dt, iv, j);
}

// chunk_walk with the tangent sums: the steps of one antithetic group over
// a chunk of kRows Z rows, from the rows in xbuf and their H tangents in
// dbuf, in rb_step<true>'s operations and order (the mirror's s dW, Z, dZ/dH
// and d(dW)/dH negated, as rb_step passes them to tangent_step).
template <int kRows>
__device__ __forceinline__ void chunk_walk_tan(const float* xs, const float* xbuf,
                                               const float* dbuf, const RbParams& p,
                                               const float4* __restrict__ coef, const RbShape& s,
                                               int chunk, bool mirror, int slot, Group& g) {
  const int k0 = chunk * kRows + 1;  // step k consumes Z row k - 1 and dW_k
  const int count = min(kRows, s.n - k0);
#pragma unroll 2
  for (int r = 0; r < count; ++r) {
    const int k = k0 + r;
    const float4 ck = __ldg(coef + 2 * k);
    const float4 ck2 = __ldg(coef + 2 * k + 1);
    const float xk = xs[k * kThreads + slot];
    const float z = xbuf[r * kThreads + slot], zd = dbuf[r * kThreads + slot];
    const float dw = __fmul_rn(ck.z, xk);
    const float ep = expf(__fmul_rn(p.eta, z));
    const float sep = sqrtf(ep);
    const float pk = __fmul_rn(ck.x, mirror ? hh::rcp(ep) : ep);
    const float sk = __fmul_rn(ck.y, mirror ? hh::rcp(sep) : sep);
    const float sdw = __fmul_rn(sk, dw);
    g.iv = __fadd_rn(g.iv, pk);
    g.j = __fadd_rn(g.j, sdw);
    const float dwd = __fmul_rn(ck.w, xk);
    tangent_step(g, pk, sk, mirror ? -sdw : sdw, mirror ? -z : z, mirror ? -zd : zd,
                 mirror ? -dwd : dwd, ck2.x, ck2.y, p.eta);
  }
}

// The tangent chunk product: rb_trip_factors's draw and product, with the H
// tangent Zd = (dL/dH) xi formed beside Z (over dpack into dbuf), and each
// thread's group walked with its tangent sums (rb_groups<true>'s, to the
// bit).  Chunks of kRows Z rows: kChunkRows (K18), every warp one tile of Z
// then one of Zd; or kChunkRows / 2 (K16), warps 0-1 a tile of Z each and
// warps 2-3 a tile of Zd each, in half the buffers.  Returns the group's
// sums in g and its signed sqrt(C_0) dW_0 and sqrt(C_0) dWd_0 (as
// rb_pair_rows forms them); the caller closes.  kSplit draws the Sobol'
// rows by draw_xi<true> (the same normals; K16).  Every thread of the block
// calls it: it holds the barriers.
template <int kRows, bool kSplit>
__device__ __forceinline__ void rb_trip_tangents(float* xs, float* xbuf, float* dbuf,
                                                 unsigned long long base, const RbParams& p,
                                                 const float4* coef, const float4* lpack,
                                                 const float4* dpack, const int* table,
                                                 const RbShape& s, uint32_t seed,
                                                 uint32_t device_id, long long point_offset,
                                                 Group& g, float& s0dw0, float& s0dwd0) {
  const int t = threadIdx.x, slot = t >> 1;
  const bool mirror = t & 1;
  __syncthreads();  // the last trip's reads of xs are done
  draw_xi<kSplit>(xs, base + t % kThreads, table, s, seed, device_id, point_offset, t % kThreads,
                  t / kThreads, kChunkThreads / kThreads);
  __syncthreads();
  g = Group{};
  for (int chunk = 0; chunk * kRows < s.n - 1; ++chunk) {
    if constexpr (kRows == kChunkRows) {
      chunk_product<kChunkWarps>(xs, lpack, s, chunk, xbuf);
      chunk_product<kChunkWarps>(xs, dpack, s, chunk, dbuf);
    } else {
      static_assert(2 * kRows == kChunkRows, "a half chunk: two tiles of Z and two of Zd");
      const bool zd = (t >> 5) >= 2;
      chunk_product<2>(xs, zd ? dpack : lpack, s, chunk, zd ? dbuf : xbuf);
    }
    __syncthreads();
    chunk_walk_tan<kRows>(xs, xbuf, dbuf, p, coef, s, chunk, mirror, slot, g);
    __syncthreads();
  }
  const float4 c0 = __ldg(coef);
  s0dw0 = __fmul_rn(c0.y, __fmul_rn(c0.z, xs[slot]));
  s0dwd0 = c0.y * __fmul_rn(c0.w, xs[slot]);
}

// The float64 sum of the 64 slots' values in red[0..63] by block_sums's
// tree (so a slot's sum reduces as one thread's does in block_sums<64>)
// into *out.
__device__ __forceinline__ void slot_tree(double* red, double* out) {
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = red[0];
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
rb_values_kernel(const float* __restrict__ params, const float4* __restrict__ coef,
                 const float4* __restrict__ lpack, const int* __restrict__ sobol,
                 float* __restrict__ out, long long n_paths, int steps, int antithetic,
                 uint32_t seed, uint32_t device_id, long long point_offset) {
  extern __shared__ float smem[];
  const RbShape s = rb_shape(steps);
  const int* table = stage_table(sobol, steps, reinterpret_cast<int*>(smem + s.xi_rows * kThreads));
  const RbParams p = *reinterpret_cast<const RbParams*>(params);
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_paths) return;
  float val, val_a;
  rb_pair_values(smem, (unsigned long long)i, p, coef, lpack, table, s, antithetic != 0, seed,
                 device_id, point_offset, val, val_a);
  out[i] = val;
  if (antithetic) out[n_paths + i] = val_a;
}

// K15: the chunked product, kThreads pairs a trip; the + thread of slot t
// adds the slot's (value + antithetic value), the slots' sums reduced as
// block_sums<64> reduces one thread's a pair.  A slot past total_pairs is
// masked: every thread stays for the barriers.
__global__ void __launch_bounds__(kChunkThreads)
rb_price_kernel(const float* __restrict__ params, const float4* __restrict__ coef,
                const float4* __restrict__ lpack, const int* __restrict__ sobol,
                double* __restrict__ partials, long long total_pairs, int steps, uint32_t seed,
                uint32_t device_id, long long point_offset) {
  extern __shared__ float4 smem4[];
  __shared__ double red[kThreads];
  float* xs = reinterpret_cast<float*>(smem4);
  const RbShape s = rb_shape(steps);
  float* xbuf = xs + s.xi_rows * kThreads;
  const int* table = stage_table(sobol, steps, reinterpret_cast<int*>(xbuf + kChunkRows * kThreads));
  const RbParams p = *reinterpret_cast<const RbParams*>(params);
  const int slot = threadIdx.x >> 1;
  const bool plus = (threadIdx.x & 1) == 0;
  float acc = 0.0f;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long base = (long long)blockIdx.x * kThreads; base < total_pairs; base += stride) {
    float iv, j;
    rb_trip_factors(xs, xbuf, (unsigned long long)base, p, coef, lpack, table, s, seed, device_id,
                    point_offset, iv, j);
    const float val = hh::cond_bs_value(iv, j, p.close);
    const float val_a = __shfl_xor_sync(0xffffffffu, val, 1);
    if (plus && base + slot < total_pairs) acc += val + val_a;
  }
  if (plus) red[slot] = (double)acc;
  slot_tree(red, partials + blockIdx.x);
}

// K16: K15's trips on the tangent chunk product over half-height chunks
// (rb_trip_tangents<kHalfChunkRows, true>: the Sobol' rows drawn split at
// bit 5), one trip of 64 pairs a block per round on K15's grid.  The +
// thread of a slot takes the mirror's sums by shuffles and closes the pair
// in one pair a thread's expressions (add_pair_rows), adding its six rows
// to the slot's fp32 sums, and each column's 64 slot sums reduce by
// slot_tree (block_sums<64>'s tree).  Slot t sums the pairs that thread t
// of a one-pair-a-thread block summed, in the same order, so K16's price is
// K15's to the bit and its columns keep the one-pair-a-thread kernel's
// bits at the same grid.  A slot past total_pairs is masked: every thread
// stays for the barriers and shuffles.  Its shared memory is K15's (the two
// half-height chunks take one chunk's bytes), so it holds K15's blocks an
// SM where its registers allow: at most 96 for 5 blocks on Philox.
__global__ void __launch_bounds__(kChunkThreads, kGreeksBlocks)
rb_greeks_kernel(const float* __restrict__ params, const float4* __restrict__ coef,
                 const float4* __restrict__ lpack, const float4* __restrict__ dpack,
                 const int* __restrict__ sobol, double* __restrict__ partials,
                 long long total_pairs, int steps, uint32_t seed, uint32_t device_id,
                 long long point_offset) {
  extern __shared__ float4 smem4[];
  __shared__ double red[kThreads];
  float* xs = reinterpret_cast<float*>(smem4);
  const RbShape s = rb_shape(steps);
  float* xbuf = xs + s.xi_rows * kThreads;
  float* dbuf = xbuf + kHalfChunkRows * kThreads;
  const int* table =
      stage_table(sobol, steps, reinterpret_cast<int*>(dbuf + kHalfChunkRows * kThreads));
  const RbParams p = *reinterpret_cast<const RbParams*>(params);
  const int slot = threadIdx.x >> 1;
  const bool mirror = threadIdx.x & 1;
  const float4 c0 = __ldg(coef);
  float acc[kGreekCols] = {};
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long base = (long long)blockIdx.x * kThreads; base < total_pairs; base += stride) {
    Group g, gm;
    float s0dw0, s0dwd0;
    rb_trip_tangents<kHalfChunkRows, true>(xs, xbuf, dbuf, (unsigned long long)base, p, coef,
                                           lpack, dpack, table, s, seed, device_id, point_offset,
                                           g, s0dw0, s0dwd0);
    // the + thread takes the mirror's sums and closes the pair
    gm.iv = __shfl_xor_sync(0xffffffffu, g.iv, 1);
    gm.j = __shfl_xor_sync(0xffffffffu, g.j, 1);
    gm.div_eta = __shfl_xor_sync(0xffffffffu, g.div_eta, 1);
    gm.dj_eta = __shfl_xor_sync(0xffffffffu, g.dj_eta, 1);
    gm.div_h = __shfl_xor_sync(0xffffffffu, g.div_h, 1);
    gm.djh_g = __shfl_xor_sync(0xffffffffu, g.djh_g, 1);
    gm.djh_s = __shfl_xor_sync(0xffffffffu, g.djh_s, 1);
    const float x0 = xs[slot];  // the next trip draws xs after a barrier
    add_pair_rows<false, kGreekCols>(g, gm, true, __fmul_rn(c0.z, x0), __fmul_rn(c0.w, x0), c0, p,
                                     1.0f, 1.0f, !mirror && base + slot < total_pairs, acc);
  }
  for (int k = 0; k < kGreekCols; ++k) {
    if (!mirror) red[slot] = (double)acc[k];
    slot_tree(red, partials + (long long)k * gridDim.x + blockIdx.x);
  }
}

__global__ void __launch_bounds__(kThreads)
rb_vjp_kernel(const float* __restrict__ params, const float4* __restrict__ coef,
              const float4* __restrict__ lpack, const float4* __restrict__ dpack,
              const int* __restrict__ sobol, const float* __restrict__ ct,
              double* __restrict__ partials, long long n_paths, int steps, int antithetic,
              uint32_t seed, uint32_t device_id, long long point_offset) {
  extern __shared__ float smem[];
  __shared__ double red[kThreads];
  const RbShape s = rb_shape(steps);
  const int* table = stage_table(sobol, steps, reinterpret_cast<int*>(smem + s.xi_rows * kThreads));
  const RbParams p = *reinterpret_cast<const RbParams*>(params);
  float acc[kVjpCols] = {};
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_paths) {
    rb_pair_rows<kVjpCols>(smem, (unsigned long long)i, p, coef, lpack, dpack, table, s,
                           antithetic != 0, seed, device_id, point_offset, ct[i],
                           antithetic ? ct[n_paths + i] : 0.0f, acc);
  }
  hh::block_sums<kThreads>(acc, red, partials);
}

// K18: one trip of 64 pairs a block (kChunkThreads threads, one antithetic
// group each) on the tangent chunk product; partials[row * gridDim.x +
// blockIdx.x] gets the block's n per-step rows, then its six scalar rows.
// After the close the + thread of a slot holds both groups' weights (one
// shuffle) and forms the pair's scalar chains and, over a replay of the L
// product, its rows R_k in one_pair_a_thread's expressions; R_k is summed
// over the 64 slots in float64 as two 32-slot butterflies added in order
// (one pair a thread's two warps), the chains by slot_tree (block_sums<64>'s).
__global__ void __launch_bounds__(kChunkThreads)
rb_vjp_curve_kernel(const float* __restrict__ params, const float4* __restrict__ coef,
                    const float4* __restrict__ lpack, const float4* __restrict__ dpack,
                    const int* __restrict__ sobol, const float* __restrict__ ct,
                    double* __restrict__ partials, long long n_paths, int steps, int antithetic,
                    uint32_t seed, uint32_t device_id, long long point_offset) {
  extern __shared__ float4 smem4[];
  __shared__ double red[kThreads];
  float* xs = reinterpret_cast<float*>(smem4);
  const RbShape s = rb_shape(steps);
  float* xbuf = xs + s.xi_rows * kThreads;
  float* dbuf = xbuf + kChunkRows * kThreads;  // the replay's rows R_k, fp32
  const int* table = stage_table(sobol, steps, reinterpret_cast<int*>(dbuf + kChunkRows * kThreads));
  const RbParams p = *reinterpret_cast<const RbParams*>(params);
  const bool anti = antithetic != 0;
  const int slot = threadIdx.x >> 1;
  const bool mirror = threadIdx.x & 1;
  const long long i = (long long)blockIdx.x * kThreads + slot;
  const bool live = i < n_paths;
  const float ct_p = live ? ct[i] : 0.0f;
  const float ct_m = live && anti ? ct[n_paths + i] : 0.0f;
  Group g;
  float s0dw0, s0dwd0;
  rb_trip_tangents<kChunkRows, false>(xs, xbuf, dbuf, (unsigned long long)blockIdx.x * kThreads, p,
                                      coef, lpack, dpack, table, s, seed, device_id, point_offset,
                                      g, s0dw0, s0dwd0);
  const float4 c0 = __ldg(coef);
  float iv, j, rows[kVjpCols];
  close_factors(g, mirror, c0.x, s0dw0, p.dt, iv, j);
  const hh::BsPartials b = group_rows<true>(g, iv, j, mirror ? -s0dwd0 : s0dwd0, p, rows);
  // the + thread takes the mirror's rows and weights (rm = {} and weight 0 unless anti)
  float rp[kVjpCols], rm[kVjpCols];
#pragma unroll
  for (int k = 0; k < kVjpCols; ++k) {
    rp[k] = rows[k];
    rm[k] = anti ? __shfl_xor_sync(0xffffffffu, rows[k], 1) : 0.0f;
  }
  const float ivw_p = b.y_iv * p.dt, jw_p = b.y_j * 0.5f;
  const float ivw_m = anti ? __shfl_xor_sync(0xffffffffu, ivw_p, 1) : 0.0f;
  const float jw_m = anti ? __shfl_xor_sync(0xffffffffu, jw_p, 1) : 0.0f;
  float acc[kCurveCols] = {};
#pragma unroll
  for (int k = 0; k < kCurveCols; ++k) {
    acc[k] += anti ? ct_p * rp[k + 1] + ct_m * rm[k + 1] : ct_p * rp[k + 1];
  }
  // per group R_k = (y_IV dt) P_k + (y_J / 2) s_k dW_k, the mirror's s dW
  // negated (its walk forms it unsigned)
  const auto row = [&](float pp, float sdw_p, float pm, float sdw_m) {
    const float r = ct_p * (ivw_p * pp + jw_p * sdw_p);
    return anti ? r + ct_m * (ivw_m * pm - jw_m * sdw_m) : r;
  };
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // R_0, then each chunk's R_k through dbuf: two 32-slot butterflies a row
  const auto sum_rows = [&](int k0, int count) {
    __syncthreads();
    for (int r = w; r < count; r += kChunkWarps) {
      const double h0 = warp_sum((double)dbuf[r * kThreads + lane]);
      const double h1 = warp_sum((double)dbuf[r * kThreads + 32 + lane]);
      if (lane == 0) partials[(long long)(k0 + r) * gridDim.x + blockIdx.x] = h0 + h1;
    }
    __syncthreads();
  };
  if (!mirror) dbuf[slot] = row(c0.x, s0dw0, c0.x, s0dw0);
  sum_rows(0, 1);
  for (int chunk = 0; chunk * kChunkRows < s.n - 1; ++chunk) {
    chunk_product<kChunkWarps>(xs, lpack, s, chunk, xbuf);
    __syncthreads();
    const int k0 = chunk * kChunkRows + 1;
    const int count = min(kChunkRows, s.n - k0);
    for (int r = 0; r < count; ++r) {
      const int k = k0 + r;
      const float4 ck = __ldg(coef + 2 * k);
      const float dw = __fmul_rn(ck.z, xs[k * kThreads + slot]);
      const float ep = expf(__fmul_rn(p.eta, xbuf[r * kThreads + slot]));
      const float sep = sqrtf(ep);
      const float pk = __fmul_rn(ck.x, mirror ? hh::rcp(ep) : ep);
      const float sdw = __fmul_rn(__fmul_rn(ck.y, mirror ? hh::rcp(sep) : sep), dw);
      const float pm = anti ? __shfl_xor_sync(0xffffffffu, pk, 1) : 0.0f;
      const float sdw_m = anti ? __shfl_xor_sync(0xffffffffu, sdw, 1) : 0.0f;
      if (!mirror) dbuf[r * kThreads + slot] = row(pk, sdw, pm, sdw_m);
    }
    sum_rows(k0, count);
  }
  for (int k = 0; k < kCurveCols; ++k) {
    if (!mirror) red[slot] = (double)acc[k];
    slot_tree(red, partials + (long long)(s.n + k) * gridDim.x + blockIdx.x);
  }
}

// K19: K15's trips, m strikes closed from each group's (IV, J); slot t's m
// fp32 sums in shared memory (added by its + thread), each strike's 64 sums
// reduced as K15's.
__global__ void __launch_bounds__(kChunkThreads)
rb_smile_kernel(const float* __restrict__ params, const float4* __restrict__ coef,
                const float4* __restrict__ lpack, const int* __restrict__ sobol,
                const float2* __restrict__ ks, int m, double* __restrict__ partials,
                long long total_pairs, int steps, uint32_t seed, uint32_t device_id,
                long long point_offset) {
  extern __shared__ float4 smem4[];
  __shared__ double red[kThreads];
  float* xs = reinterpret_cast<float*>(smem4);
  const RbShape s = rb_shape(steps);
  float* xbuf = xs + s.xi_rows * kThreads;
  const int* table = stage_table(sobol, steps, reinterpret_cast<int*>(xbuf + kChunkRows * kThreads));
  float* acc = xbuf + kChunkRows * kThreads + table_words(steps, sobol != nullptr);
  for (int i = threadIdx.x; i < m * kThreads; i += kChunkThreads) acc[i] = 0.0f;
  const RbParams p = *reinterpret_cast<const RbParams*>(params);
  const int slot = threadIdx.x >> 1;
  const bool plus = (threadIdx.x & 1) == 0;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long base = (long long)blockIdx.x * kThreads; base < total_pairs; base += stride) {
    float iv, j;
    rb_trip_factors(xs, xbuf, (unsigned long long)base, p, coef, lpack, table, s, seed, device_id,
                    point_offset, iv, j);
    const hh::CloseGroup g = hh::close_group(iv, j, p.close);
    const bool live = plus && base + slot < total_pairs;
    for (int k = 0; k < m; ++k) {
      const float2 q = __ldg(ks + k);  // (log(f_base / K), K)
      const float val = hh::close_value(g, q.x, q.y, p.close.cp);
      const float val_a = __shfl_xor_sync(0xffffffffu, val, 1);
      if (live) acc[k * kThreads + slot] += val + val_a;
    }
  }
  __syncthreads();
  for (int k = 0; k < m; ++k) {
    if (threadIdx.x < kThreads) red[threadIdx.x] = (double)acc[k * kThreads + threadIdx.x];
    slot_tree(red, partials + (long long)k * gridDim.x + blockIdx.x);
  }
}

// Opts the kernel into `smem` bytes of dynamic shared memory (above 48 KB a
// block must ask).
template <class K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// Per-path undiscounted values: out is (1 or 2, n_paths) float32.
extern "C" int hh_rb_values(const float* params, const float* coef, const float* lpack,
                            const int* sobol, float* out, long long n_paths, int steps,
                            int antithetic, unsigned seed, unsigned device_id,
                            long long point_offset, void* stream) {
  const size_t smem = rb_smem(steps, sobol != nullptr);
  cudaError_t err = allow_smem(rb_values_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n_paths + kThreads - 1) / kThreads;
  rb_values_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      params, reinterpret_cast<const float4*>(coef), reinterpret_cast<const float4*>(lpack), sobol,
      out, n_paths, steps, antithetic, seed, device_id, point_offset);
  return (int)cudaGetLastError();
}

// Sums of (value + antithetic value) over the pairs [0, total_pairs):
// partials is (grid,) float64, one per block.
extern "C" int hh_rb_price(const float* params, const float* coef, const float* lpack,
                           const int* sobol, double* partials, int grid, long long total_pairs,
                           int steps, unsigned seed, unsigned device_id, long long point_offset,
                           void* stream) {
  const size_t smem = rb_chunk_smem(steps, sobol != nullptr);
  cudaError_t err = allow_smem(rb_price_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  rb_price_kernel<<<grid, kChunkThreads, smem, (cudaStream_t)stream>>>(
      params, reinterpret_cast<const float4*>(coef), reinterpret_cast<const float4*>(lpack), sobol,
      partials, total_pairs, steps, seed, device_id, point_offset);
  return (int)cudaGetLastError();
}

// Price and greek sums over the pairs [0, total_pairs): partials is
// (6, grid) float64, column-major by sum.
extern "C" int hh_rb_greeks(const float* params, const float* coef, const float* lpack,
                            const float* dpack, const int* sobol, double* partials, int grid,
                            long long total_pairs, int steps, unsigned seed, unsigned device_id,
                            long long point_offset, void* stream) {
  const size_t smem = rb_greeks_smem(steps, sobol != nullptr);
  cudaError_t err = allow_smem(rb_greeks_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  rb_greeks_kernel<<<grid, kChunkThreads, smem, (cudaStream_t)stream>>>(
      params, reinterpret_cast<const float4*>(coef), reinterpret_cast<const float4*>(lpack),
      reinterpret_cast<const float4*>(dpack), sobol, partials, total_pairs, steps, seed,
      device_id, point_offset);
  return (int)cudaGetLastError();
}

// Cotangent-weighted sums over the paths: ct is (1 or 2, n_paths) float32,
// partials (7, ceil(n_paths / 64)) float64.
extern "C" int hh_rb_values_vjp(const float* params, const float* coef, const float* lpack,
                                const float* dpack, const int* sobol, const float* ct,
                                double* partials, long long n_paths, int steps, int antithetic,
                                unsigned seed, unsigned device_id, long long point_offset,
                                void* stream) {
  const size_t smem = rb_smem(steps, sobol != nullptr);
  cudaError_t err = allow_smem(rb_vjp_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n_paths + kThreads - 1) / kThreads;
  rb_vjp_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      params, reinterpret_cast<const float4*>(coef), reinterpret_cast<const float4*>(lpack),
      reinterpret_cast<const float4*>(dpack), sobol, ct, partials, n_paths, steps, antithetic,
      seed, device_id, point_offset);
  return (int)cudaGetLastError();
}

// K18's sums: ct is (1 or 2, n_paths) float32, partials (n + 6,
// ceil(n_paths / 64)) float64: the n per-step rows d/d ln C_k, then chain_eta,
// chain_H, chain_T, w, y_rho, y_K.
extern "C" int hh_rb_values_vjp_curve(const float* params, const float* coef, const float* lpack,
                                      const float* dpack, const int* sobol, const float* ct,
                                      double* partials, long long n_paths, int steps,
                                      int antithetic, unsigned seed, unsigned device_id,
                                      long long point_offset, void* stream) {
  const size_t smem = rb_curve_smem(steps, sobol != nullptr);
  cudaError_t err = allow_smem(rb_vjp_curve_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n_paths + kThreads - 1) / kThreads;
  rb_vjp_curve_kernel<<<(unsigned)blocks, kChunkThreads, smem, (cudaStream_t)stream>>>(
      params, reinterpret_cast<const float4*>(coef), reinterpret_cast<const float4*>(lpack),
      reinterpret_cast<const float4*>(dpack), sobol, ct, partials, n_paths, steps, antithetic,
      seed, device_id, point_offset);
  return (int)cudaGetLastError();
}

// K19's sums of (value + antithetic value) per strike over the pairs
// [0, total_pairs): ks is (m, 2) float32 (log(f_base / K), K), partials
// (m, grid) float64; grid is K15's (hh_rb_price_grid).
extern "C" int hh_rb_smile(const float* params, const float* coef, const float* lpack,
                           const int* sobol, const float* ks, int m, double* partials, int grid,
                           long long total_pairs, int steps, unsigned seed, unsigned device_id,
                           long long point_offset, void* stream) {
  if (m < 1 || m > kMaxStrikes) return (int)cudaErrorInvalidValue;
  const size_t smem = rb_chunk_smem(steps, sobol != nullptr) + sizeof(float) * m * kThreads;
  cudaError_t err = allow_smem(rb_smile_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  rb_smile_kernel<<<grid, kChunkThreads, smem, (cudaStream_t)stream>>>(
      params, reinterpret_cast<const float4*>(coef), reinterpret_cast<const float4*>(lpack), sobol,
      reinterpret_cast<const float2*>(ks), m, partials, total_pairs, steps, seed, device_id,
      point_offset);
  return (int)cudaGetLastError();
}

// The occupancy on the current device at `steps` steps, with or without
// the Sobol' table, of the block-cooperative kernels: out = (threads a
// block, resident blocks per SM, SMs, dynamic shared bytes, static shared
// bytes, registers a thread, local (spill) bytes a thread).
template <class K>
int chunk_occupancy(K kernel, size_t smem, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaFuncAttributes attr{};
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = allow_smem(kernel, smem);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kChunkThreads, smem);
  }
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  const int vals[7] = {kChunkThreads, per_sm, sms, (int)smem, (int)attr.sharedSizeBytes,
                       attr.numRegs, (int)attr.localSizeBytes};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return (int)err;
}

// K15's.
extern "C" int hh_rb_price_occupancy(int steps, int qmc, int* out) {
  return chunk_occupancy(rb_price_kernel, rb_chunk_smem(steps, qmc != 0), out);
}

// K16's.
extern "C" int hh_rb_greeks_occupancy(int steps, int qmc, int* out) {
  return chunk_occupancy(rb_greeks_kernel, rb_greeks_smem(steps, qmc != 0), out);
}

// K18's.
extern "C" int hh_rb_vjp_curve_occupancy(int steps, int qmc, int* out) {
  return chunk_occupancy(rb_vjp_curve_kernel, rb_curve_smem(steps, qmc != 0), out);
}

// The price kernels' grid (K15; K16, which walks K15's trips for its price
// to equal K15's, and holds as many blocks an SM; K19): one resident wave
// of K15.
extern "C" int hh_rb_price_grid(int steps, int qmc, int* grid) {
  int occ[7];
  const int err = hh_rb_price_occupancy(steps, qmc, occ);
  *grid = occ[2] * (occ[1] > 0 ? occ[1] : 1);
  return err;
}
