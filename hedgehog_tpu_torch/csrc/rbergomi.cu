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
// 2n normals comes on top.  On an H100 they run 4-6x above that operation
// bound (PERF.md): latency-bound chains, not the issue rate of any one pipe.
//
// All six run one block-cooperative product over row chunks.  A block of
// 128 threads takes 64 consecutive pairs a trip: the threads draw the 64 xi
// columns into shared memory (two threads a column; row-major, one float a
// pair a row), then for each chunk of 32 Z rows every warp forms one 8-row
// tile's rows for all 64 pairs, a lane 4 pairs x 4 rows in registers (one
// LDS.128 of each xi and two warp-uniform LDG.128 of the factor's packed
// entries per column: 4 loads per 32 FMAs, each factor value feeding 4
// pairs), into an 8 KB chunk buffer; after a barrier each thread walks one
// antithetic group of one pair through the chunk's steps (the mirror's
// thread takes rcp of the exponentials it recomputes: X(-xi) = -X), so the
// state is O(1) a path and the whole X is never held.  Z row j sums its
// columns 0..j in order, each column's increment entry then its Z entry by
// fmaf, and a step rounds each product and sum on its own
// (__fmul_rn/__fadd_rn, as the twins do), so every kernel computes a pair's
// (IV, J) to the same bits whatever the chunk that holds its tile, the
// trip or the grid.  Up to kStagedSteps (256) steps the xi columns (2n rows
// padded to whole tiles) and the Sobol' table sit in shared memory: at 256
// steps under QMC they take 192 KB of the 227 KB a block may use.  Past
// that a second instantiation of each kernel (kWide) reads the table from
// global memory and keeps the xi columns in a slab of global scratch per
// block (`slab`, the caller's), so its shared memory is the chunk buffers
// alone; K17 and K18 then walk their trips on a resident grid (`trips`
// partials, trip `trip` where the staged kernels have block blockIdx.x, so
// the same bits).  The operations are the same: every pair's (IV, J) is.
// Measured (PERF.md, H100, K15 at 2^22 pairs): the xi columns kept in
// shared memory at 320 steps hold one block an SM and took 271 ms; in the
// slab, 7 blocks an SM, 86 ms.
//
// Trips and grids.  Slot t of the trip at `base` walks pair base + t.  K15
// and K19 walk trips on one resident wave of K15 (blockIdx.x * 64 + t +
// trip * grid * 64), the 64 slot sums reduced by block_sums<64>'s tree, and
// K16 walks K15's trips on K15's grid, so K16's price and each of K19's
// strikes are K15's to the bit.  K14 walks trips on a resident wave of its
// own (each value is its pair's whatever the grid), so a block stages the
// Sobol' table once.  K17 and K18 take one trip a block, ceil(n / 64)
// blocks: slot t is thread t of a 64-thread block one pair a thread, so
// their float64 partials keep that grid's bits.  K14, K16 and K17 draw
// their Sobol' rows split at bit 5 (draw_xi<true>: the same integers, so
// the same normals), K15, K18 and K19 through hh::sobol_normal.
//
// The tangent product (K16, K17, K18; rb_trip_tangents) forms the H tangent
// Zd = (dL/dH) xi beside Z and walks each group with its tangent sums in
// (xi0, eta, H).  K16 and K17 take 16-row chunks, warps 0-1 a tile of Z
// each and warps 2-3 a tile of Zd, in K15's bytes, so they hold K15's
// blocks an SM where their registers allow (at most 96 for 5 on Philox).
// Their + thread takes the mirror's sums by shuffles and closes both groups
// in one function (add_pair_rows), K16 unweighted into its six columns, K17
// weighted by the pair's two cotangents into its seven.  Measured (PERF.md,
// H100) against one pair a thread, PRNG and QMC: K14 1.86x and 1.75x, K15
// 1.6x, K16 1.84x and 1.26x, K17 1.98x and 2.17x, K18 1.37x and 1.72x, K19
// 1.3x faster.  The Sobol' table read through L1 instead of staged was
// slower (QMC K15 39.7 against 28.7 ms at 2^24 pairs); under QMC the draw,
// most of it ndtri_approx's two branches in every warp, is a third of K16's
// time.
//
// K18 (the backward of the values under a ForwardVarianceCurve) adds one row
// per step, R_k = ct (y_IV dt P_k + y_J/2 s_k dW_k) = d(ct value)/d ln C_k,
// whose weights y_IV and y_J are known only after the close.  Keeping each
// pair's Z (or P_k and s_k dW_k) through the product would cost another n
// floats a pair of shared memory (64 KB more a block at 256 steps, over
// the 227 KB limit with the xi columns and the Sobol' table), so K18 replays
// the L product once the close is done: the same fp32 operations, so the
// same P_k and s_k dW_k bits, for one more n(n-1) FMAs a pair.  It takes
// 32-row chunks of Z and of Zd (two chunk_products), closes each group on
// its own thread, and the + thread of a slot takes the mirror's rows by
// shuffles to form the pair's six scalar chains and, over the replay, its
// R_k.  R_k is summed over the 64 slots in float64 as two 32-slot
// butterflies added in order (a 64-thread block's two warps) into (n + 6,
// blocks) float64 partials, the chains by block_sums<64>'s tree.
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
constexpr int kStagedSteps = 256;  // ops/rbergomi_kernel.py STAGED_STEPS

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

// Past kStagedSteps a launch runs the wide instantiation.
bool wide(int steps) { return steps > kStagedSteps; }

// The xi columns and the Sobol' table, staged up to kStagedSteps (none
// past it): the chunk kernels add their chunk buffers between the two.
size_t rb_smem(int steps, bool qmc) {
  const RbShape s = rb_shape(steps);
  return wide(steps) ? 0
                     : sizeof(float) * ((size_t)s.xi_rows * kThreads + table_words(steps, qmc));
}

// The block's xi columns: in shared memory at `smem`, or for a wide kernel
// its slab of the global scratch.
template <bool kWide>
__device__ __forceinline__ float* xi_columns(float* smem, float* slab, const RbShape& s) {
  if constexpr (kWide) return slab + (size_t)blockIdx.x * s.xi_rows * kThreads;
  return smem;
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

// One pair's close in one thread: each group's tangent rows (group_rows on
// close_factors) from its sums, weighted by ct_p and ct_m (K16: 1, 1; K17:
// the pair's cotangents) and added into acc where `add`.  dw0 and dwd0 are
// the pair's first increment and its H tangent.  K16 and K17 close through
// this one function, in the expressions of their one-pair-a-thread
// kernels, so their rows keep those kernels' bits.
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

// The float64 sum of x over the warp, the same bits in every lane (a
// butterfly).
__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---- the block-cooperative product over row chunks ---------------------------
//
// A block of kChunkThreads threads takes kThreads consecutive pairs a trip:
// slot t of the trip at `base` is pair base + t, walked by threads 2t (the
// + group) and 2t + 1 (the mirror).

constexpr int kChunkThreads = 128;
constexpr int kChunkWarps = kChunkThreads / 32;
constexpr int kChunkRows = kChunkWarps * kTile;  // Z rows a chunk: one tile a warp
constexpr int kQuad = 4;                          // pairs of a register tile
constexpr int kHalf = kTile / 2;                  // rows of a register tile
constexpr int kHalfChunkRows = kChunkRows / 2;    // Z rows of a chunk of K16
constexpr int kChunkBlocks = 5;  // K14's, K16's and K17's blocks an SM on Philox at 64 steps
static_assert(kChunkThreads == 2 * kThreads, "the walk takes one antithetic group a thread");
static_assert(kThreads == 16 * kQuad, "a warp is one tile: 16 quads of pairs x 2 half tiles");

// Dynamic shared memory of K15 and K14 (K19 adds its strike sums): the xi
// columns, the chunk of Z rows, then the Sobol' table.
size_t rb_chunk_smem(int steps, bool qmc) {
  return rb_smem(steps, qmc) + sizeof(float) * kChunkRows * kThreads;
}

// K16's and K17's: the xi columns, the half-height chunks of Z and of its H
// tangent, then the Sobol' table: K15's bytes.
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
// in xa and xi_{n+c} in xb; per output the increment's FMA, then Z's.
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
// columns 0..row in order (quad_col), so each pair's Z has the same bits
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
// the mirror from rcp of the + group's exponentials; P = C_k e^{eta Z},
// s = sqrt(P) and s dW_k each rounded on its own, each sum in step order.
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

// The trip's xi columns, from pair `base`: two threads a column (thread t
// draws every other row of slot t % 64, from its t / 64-th), so each warp
// holds 32 consecutive pairs and one part, as draw_xi<true> needs.  kSplit
// draws the Sobol' rows split at bit 5 (the same normals).  Every thread of
// the block calls it: it holds the barriers.
template <bool kSplit>
__device__ __forceinline__ void draw_trip(float* xs, unsigned long long base, const int* table,
                                          const RbShape& s, uint32_t seed, uint32_t device_id,
                                          long long point_offset) {
  const int t = threadIdx.x;
  __syncthreads();  // the last trip's reads of xs are done
  draw_xi<kSplit>(xs, base + t % kThreads, table, s, seed, device_id, point_offset, t % kThreads,
                  t / kThreads, kChunkThreads / kThreads);
  __syncthreads();
}

// The (IV, J) of this thread's group of the trip's slot threadIdx.x / 2
// (even threads the + group, odd ones the mirror): the block draws the
// trip's xi columns (draw_trip<kSplit>), then each chunk's product and walk.
// Every thread of the block calls it: it holds the barriers.
template <bool kSplit = false>
__device__ __forceinline__ void rb_trip_factors(float* xs, float* xbuf, unsigned long long base,
                                                const RbParams& p, const float4* coef,
                                                const float4* lpack, const int* table,
                                                const RbShape& s, uint32_t seed,
                                                uint32_t device_id, long long point_offset,
                                                float& iv, float& j) {
  const int t = threadIdx.x, slot = t >> 1;
  const bool mirror = t & 1;
  draw_trip<kSplit>(xs, base, table, s, seed, device_id, point_offset);
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
// dbuf, chunk_walk's primal operations and order, then tangent_step's (the
// mirror's s dW, Z, dZ/dH and d(dW)/dH negated).
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
// thread's group walked with its tangent sums (chunk_walk_tan).  Chunks of
// kRows Z rows: kChunkRows (K18), every warp one tile of Z then one of Zd;
// or kChunkRows / 2 (K16, K17), warps 0-1 a tile of Z each and warps 2-3 a
// tile of Zd each, in half the buffers.  Returns the group's sums in g and
// the + group's sqrt(C_0) dW_0 and sqrt(C_0) dWd_0; the caller closes.
// kSplit draws the Sobol' rows split at bit 5 (the same normals; K16, K17).
// Every thread of the block calls it: it holds the barriers.
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
  draw_trip<kSplit>(xs, base, table, s, seed, device_id, point_offset);
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

// The mirror's sums, for the + thread of each slot (by shuffles; every
// thread of the warp calls it).
__device__ __forceinline__ Group mirror_sums(const Group& g) {
  Group m;
  m.iv = __shfl_xor_sync(0xffffffffu, g.iv, 1);
  m.j = __shfl_xor_sync(0xffffffffu, g.j, 1);
  m.div_eta = __shfl_xor_sync(0xffffffffu, g.div_eta, 1);
  m.dj_eta = __shfl_xor_sync(0xffffffffu, g.dj_eta, 1);
  m.div_h = __shfl_xor_sync(0xffffffffu, g.div_h, 1);
  m.djh_g = __shfl_xor_sync(0xffffffffu, g.djh_g, 1);
  m.djh_s = __shfl_xor_sync(0xffffffffu, g.djh_s, 1);
  return m;
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

// K14: trips of 64 pairs on one resident wave of K14 (rb_trip_factors<true>:
// K15's product, the Sobol' rows drawn split at bit 5); each thread closes
// its group, the + thread of slot t writing out[base + t] and, under
// antithetic, the mirror thread out[n_paths + base + t] (a non-antithetic
// call discards the mirror's group).  A value depends on its pair alone,
// not on the grid or the trip.  A slot past n_paths is masked: every
// thread stays for the barriers.
template <bool kWide>
__global__ void __launch_bounds__(kChunkThreads, kChunkBlocks)
rb_values_kernel(const float* __restrict__ params, const float4* __restrict__ coef,
                 const float4* __restrict__ lpack, const int* __restrict__ sobol,
                 float* __restrict__ out, long long n_paths, int steps, int antithetic,
                 uint32_t seed, uint32_t device_id, long long point_offset, float* slab) {
  extern __shared__ float4 smem4[];
  const RbShape s = rb_shape(steps);
  float* xs = xi_columns<kWide>(reinterpret_cast<float*>(smem4), slab, s);
  float* xbuf = kWide ? reinterpret_cast<float*>(smem4) : xs + s.xi_rows * kThreads;
  const int* table =
      kWide ? sobol : stage_table(sobol, steps, reinterpret_cast<int*>(xbuf + kChunkRows * kThreads));
  const RbParams p = *reinterpret_cast<const RbParams*>(params);
  const int slot = threadIdx.x >> 1;
  const bool mirror = threadIdx.x & 1;
  float* dst = out + (mirror ? n_paths : 0);
  const bool write = !mirror || antithetic != 0;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long base = (long long)blockIdx.x * kThreads; base < n_paths; base += stride) {
    float iv, j;
    rb_trip_factors<true>(xs, xbuf, (unsigned long long)base, p, coef, lpack, table, s, seed,
                          device_id, point_offset, iv, j);
    const float val = hh::cond_bs_value(iv, j, p.close);
    if (base + slot < n_paths && write) dst[base + slot] = val;
  }
}

// K15: the chunked product, kThreads pairs a trip; the + thread of slot t
// adds the slot's (value + antithetic value), the slots' sums reduced as
// block_sums<64> reduces one thread's a pair.  A slot past total_pairs is
// masked: every thread stays for the barriers.
template <bool kWide>
__global__ void __launch_bounds__(kChunkThreads)
rb_price_kernel(const float* __restrict__ params, const float4* __restrict__ coef,
                const float4* __restrict__ lpack, const int* __restrict__ sobol,
                double* __restrict__ partials, long long total_pairs, int steps, uint32_t seed,
                uint32_t device_id, long long point_offset, float* slab) {
  extern __shared__ float4 smem4[];
  __shared__ double red[kThreads];
  const RbShape s = rb_shape(steps);
  float* xs = xi_columns<kWide>(reinterpret_cast<float*>(smem4), slab, s);
  float* xbuf = kWide ? reinterpret_cast<float*>(smem4) : xs + s.xi_rows * kThreads;
  const int* table =
      kWide ? sobol : stage_table(sobol, steps, reinterpret_cast<int*>(xbuf + kChunkRows * kThreads));
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
template <bool kWide>
__global__ void __launch_bounds__(kChunkThreads, kChunkBlocks)
rb_greeks_kernel(const float* __restrict__ params, const float4* __restrict__ coef,
                 const float4* __restrict__ lpack, const float4* __restrict__ dpack,
                 const int* __restrict__ sobol, double* __restrict__ partials,
                 long long total_pairs, int steps, uint32_t seed, uint32_t device_id,
                 long long point_offset, float* slab) {
  extern __shared__ float4 smem4[];
  __shared__ double red[kThreads];
  const RbShape s = rb_shape(steps);
  float* xs = xi_columns<kWide>(reinterpret_cast<float*>(smem4), slab, s);
  float* xbuf = kWide ? reinterpret_cast<float*>(smem4) : xs + s.xi_rows * kThreads;
  float* dbuf = xbuf + kHalfChunkRows * kThreads;
  const int* table = kWide ? sobol
                           : stage_table(sobol, steps,
                                         reinterpret_cast<int*>(dbuf + kHalfChunkRows * kThreads));
  const RbParams p = *reinterpret_cast<const RbParams*>(params);
  const int slot = threadIdx.x >> 1;
  const bool mirror = threadIdx.x & 1;
  const float4 c0 = __ldg(coef);
  float acc[kGreekCols] = {};
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long base = (long long)blockIdx.x * kThreads; base < total_pairs; base += stride) {
    Group g;
    float s0dw0, s0dwd0;
    rb_trip_tangents<kHalfChunkRows, true>(xs, xbuf, dbuf, (unsigned long long)base, p, coef,
                                           lpack, dpack, table, s, seed, device_id, point_offset,
                                           g, s0dw0, s0dwd0);
    const Group gm = mirror_sums(g);  // the + thread closes the pair
    const float x0 = xs[slot];  // the next trip draws xs after a barrier
    add_pair_rows<false, kGreekCols>(g, gm, true, __fmul_rn(c0.z, x0), __fmul_rn(c0.w, x0), c0, p,
                                     1.0f, 1.0f, !mirror && base + slot < total_pairs, acc);
  }
  for (int k = 0; k < kGreekCols; ++k) {
    if (!mirror) red[slot] = (double)acc[k];
    slot_tree(red, partials + (long long)k * gridDim.x + blockIdx.x);
  }
}

// K17: one trip of 64 pairs a block (slot t is thread t of a 64-thread
// block one pair a thread: pair blockIdx.x * 64 + t) on K16's tangent chunk
// product (rb_trip_tangents<kHalfChunkRows, true>).  The + thread of a slot
// takes the mirror's sums by shuffles and closes the pair in K16's close
// (add_pair_rows), its seven rows weighted by the pair's cotangents; each
// column's 64 slot rows reduce by slot_tree (block_sums<64>'s tree) into
// partials (7, blocks).  A slot past n_paths is masked and a non-antithetic
// call discards the mirror's group: every thread stays for the barriers
// and shuffles.  Its shared memory is K16's (K15's bytes).
template <bool kWide>
__global__ void __launch_bounds__(kChunkThreads, kChunkBlocks)
rb_vjp_kernel(const float* __restrict__ params, const float4* __restrict__ coef,
              const float4* __restrict__ lpack, const float4* __restrict__ dpack,
              const int* __restrict__ sobol, const float* __restrict__ ct,
              double* __restrict__ partials, long long n_paths, int steps, int antithetic,
              uint32_t seed, uint32_t device_id, long long point_offset, float* slab) {
  extern __shared__ float4 smem4[];
  __shared__ double red[kThreads];
  const RbShape s = rb_shape(steps);
  float* xs = xi_columns<kWide>(reinterpret_cast<float*>(smem4), slab, s);
  float* xbuf = kWide ? reinterpret_cast<float*>(smem4) : xs + s.xi_rows * kThreads;
  float* dbuf = xbuf + kHalfChunkRows * kThreads;
  const int* table = kWide ? sobol
                           : stage_table(sobol, steps,
                                         reinterpret_cast<int*>(dbuf + kHalfChunkRows * kThreads));
  const RbParams p = *reinterpret_cast<const RbParams*>(params);
  const bool anti = antithetic != 0;
  const int slot = threadIdx.x >> 1;
  const bool mirror = threadIdx.x & 1;
  // trip `trip` of `trips` (the staged kernel: trip blockIdx.x of gridDim.x)
  const auto trip_sums = [&](long long trip, long long trips) {
    const long long base = trip * kThreads, i = base + slot;
    const bool live = !mirror && i < n_paths;
    Group g;
    float s0dw0, s0dwd0;
    rb_trip_tangents<kHalfChunkRows, true>(xs, xbuf, dbuf, (unsigned long long)base, p, coef,
                                           lpack, dpack, table, s, seed, device_id, point_offset,
                                           g, s0dw0, s0dwd0);
    const Group gm = mirror_sums(g);
    const float ct_p = live ? ct[i] : 0.0f;
    const float ct_m = live && anti ? ct[n_paths + i] : 0.0f;
    const float4 c0 = __ldg(coef);
    const float x0 = xs[slot];
    float acc[kVjpCols] = {};
    add_pair_rows<true, kVjpCols>(g, gm, anti, __fmul_rn(c0.z, x0), __fmul_rn(c0.w, x0), c0, p,
                                  ct_p, ct_m, live, acc);
    for (int k = 0; k < kVjpCols; ++k) {
      if (!mirror) red[slot] = (double)acc[k];
      slot_tree(red, partials + (long long)k * trips + trip);
    }
  };
  if constexpr (kWide) {
    const long long trips = (n_paths + kThreads - 1) / kThreads;
    for (long long trip = blockIdx.x; trip < trips; trip += gridDim.x) trip_sums(trip, trips);
  } else {
    trip_sums(blockIdx.x, gridDim.x);
  }
}

// K18: one trip of 64 pairs a block (kChunkThreads threads, one antithetic
// group each) on the tangent chunk product; partials[row * trips + trip]
// gets the trip's n per-step rows, then its six scalar rows.
// After the close the + thread of a slot holds both groups' weights (one
// shuffle) and forms the pair's scalar chains and, over a replay of the L
// product, its rows R_k in one_pair_a_thread's expressions; R_k is summed
// over the 64 slots in float64 as two 32-slot butterflies added in order
// (one pair a thread's two warps), the chains by slot_tree (block_sums<64>'s).
template <bool kWide>
__global__ void __launch_bounds__(kChunkThreads)
rb_vjp_curve_kernel(const float* __restrict__ params, const float4* __restrict__ coef,
                    const float4* __restrict__ lpack, const float4* __restrict__ dpack,
                    const int* __restrict__ sobol, const float* __restrict__ ct,
                    double* __restrict__ partials, long long n_paths, int steps, int antithetic,
                    uint32_t seed, uint32_t device_id, long long point_offset, float* slab) {
  extern __shared__ float4 smem4[];
  __shared__ double red[kThreads];
  const RbShape s = rb_shape(steps);
  float* xs = xi_columns<kWide>(reinterpret_cast<float*>(smem4), slab, s);
  float* xbuf = kWide ? reinterpret_cast<float*>(smem4) : xs + s.xi_rows * kThreads;
  float* dbuf = xbuf + kChunkRows * kThreads;  // the replay's rows R_k, fp32
  const int* table =
      kWide ? sobol : stage_table(sobol, steps, reinterpret_cast<int*>(dbuf + kChunkRows * kThreads));
  const RbParams p = *reinterpret_cast<const RbParams*>(params);
  const bool anti = antithetic != 0;
  const int slot = threadIdx.x >> 1;
  const bool mirror = threadIdx.x & 1;
  // trip `trip` of `trips` (the staged kernel: trip blockIdx.x of gridDim.x)
  const auto trip_sums = [&](long long trip, long long trips) {
    const long long i = trip * kThreads + slot;
    const bool live = i < n_paths;
    const float ct_p = live ? ct[i] : 0.0f;
    const float ct_m = live && anti ? ct[n_paths + i] : 0.0f;
    Group g;
    float s0dw0, s0dwd0;
    rb_trip_tangents<kChunkRows, false>(xs, xbuf, dbuf, (unsigned long long)trip * kThreads, p,
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
        if (lane == 0) partials[(long long)(k0 + r) * trips + trip] = h0 + h1;
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
      slot_tree(red, partials + (long long)(s.n + k) * trips + trip);
    }
  };
  if constexpr (kWide) {
    const long long trips = (n_paths + kThreads - 1) / kThreads;
    for (long long trip = blockIdx.x; trip < trips; trip += gridDim.x) trip_sums(trip, trips);
  } else {
    trip_sums(blockIdx.x, gridDim.x);
  }
}

// K19: K15's trips, m strikes closed from each group's (IV, J); slot t's m
// fp32 sums in shared memory (added by its + thread), each strike's 64 sums
// reduced as K15's.
template <bool kWide>
__global__ void __launch_bounds__(kChunkThreads)
rb_smile_kernel(const float* __restrict__ params, const float4* __restrict__ coef,
                const float4* __restrict__ lpack, const int* __restrict__ sobol,
                const float2* __restrict__ ks, int m, double* __restrict__ partials,
                long long total_pairs, int steps, uint32_t seed, uint32_t device_id,
                long long point_offset, float* slab) {
  extern __shared__ float4 smem4[];
  __shared__ double red[kThreads];
  const RbShape s = rb_shape(steps);
  float* xs = xi_columns<kWide>(reinterpret_cast<float*>(smem4), slab, s);
  float* xbuf = kWide ? reinterpret_cast<float*>(smem4) : xs + s.xi_rows * kThreads;
  const int* table =
      kWide ? sobol : stage_table(sobol, steps, reinterpret_cast<int*>(xbuf + kChunkRows * kThreads));
  float* acc = xbuf + kChunkRows * kThreads + (kWide ? 0 : table_words(steps, sobol != nullptr));
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

// Per-path undiscounted values: out is (1 or 2, n_paths) float32; grid is
// K14's resident wave (hh_rb_values_grid) or fewer blocks.  slab: past
// kStagedSteps the xi columns of grid blocks in global memory, else unread.
extern "C" int hh_rb_values(const float* params, const float* coef, const float* lpack,
                            const int* sobol, float* out, int grid, long long n_paths, int steps,
                            int antithetic, unsigned seed, unsigned device_id,
                            long long point_offset, float* slab, void* stream) {
  const size_t smem = rb_chunk_smem(steps, sobol != nullptr);
  const auto kernel = wide(steps) ? rb_values_kernel<true> : rb_values_kernel<false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kChunkThreads, smem, (cudaStream_t)stream>>>(
      params, reinterpret_cast<const float4*>(coef), reinterpret_cast<const float4*>(lpack), sobol,
      out, n_paths, steps, antithetic, seed, device_id, point_offset, slab);
  return (int)cudaGetLastError();
}

// Sums of (value + antithetic value) over the pairs [0, total_pairs):
// partials is (grid,) float64, one per block.
extern "C" int hh_rb_price(const float* params, const float* coef, const float* lpack,
                           const int* sobol, double* partials, int grid, long long total_pairs,
                           int steps, unsigned seed, unsigned device_id, long long point_offset,
                           float* slab, void* stream) {
  const size_t smem = rb_chunk_smem(steps, sobol != nullptr);
  const auto kernel = wide(steps) ? rb_price_kernel<true> : rb_price_kernel<false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kChunkThreads, smem, (cudaStream_t)stream>>>(
      params, reinterpret_cast<const float4*>(coef), reinterpret_cast<const float4*>(lpack), sobol,
      partials, total_pairs, steps, seed, device_id, point_offset, slab);
  return (int)cudaGetLastError();
}

// Price and greek sums over the pairs [0, total_pairs): partials is
// (6, grid) float64, column-major by sum.
extern "C" int hh_rb_greeks(const float* params, const float* coef, const float* lpack,
                            const float* dpack, const int* sobol, double* partials, int grid,
                            long long total_pairs, int steps, unsigned seed, unsigned device_id,
                            long long point_offset, float* slab, void* stream) {
  const size_t smem = rb_greeks_smem(steps, sobol != nullptr);
  const auto kernel = wide(steps) ? rb_greeks_kernel<true> : rb_greeks_kernel<false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kChunkThreads, smem, (cudaStream_t)stream>>>(
      params, reinterpret_cast<const float4*>(coef), reinterpret_cast<const float4*>(lpack),
      reinterpret_cast<const float4*>(dpack), sobol, partials, total_pairs, steps, seed,
      device_id, point_offset, slab);
  return (int)cudaGetLastError();
}

// Cotangent-weighted sums over the paths: ct is (1 or 2, n_paths) float32,
// partials (7, ceil(n_paths / 64)) float64, a column a trip of 64 pairs.  Up
// to kStagedSteps one block a trip (grid is ignored); past that grid blocks
// walk the trips.
extern "C" int hh_rb_values_vjp(const float* params, const float* coef, const float* lpack,
                                const float* dpack, const int* sobol, const float* ct,
                                double* partials, long long n_paths, int steps, int antithetic,
                                unsigned seed, unsigned device_id, long long point_offset,
                                int grid, float* slab, void* stream) {
  const size_t smem = rb_greeks_smem(steps, sobol != nullptr);
  const auto kernel = wide(steps) ? rb_vjp_kernel<true> : rb_vjp_kernel<false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = wide(steps) ? grid : (n_paths + kThreads - 1) / kThreads;
  kernel<<<(unsigned)blocks, kChunkThreads, smem, (cudaStream_t)stream>>>(
      params, reinterpret_cast<const float4*>(coef), reinterpret_cast<const float4*>(lpack),
      reinterpret_cast<const float4*>(dpack), sobol, ct, partials, n_paths, steps, antithetic,
      seed, device_id, point_offset, slab);
  return (int)cudaGetLastError();
}

// K18's sums: ct is (1 or 2, n_paths) float32, partials (n + 6,
// ceil(n_paths / 64)) float64: the n per-step rows d/d ln C_k, then chain_eta,
// chain_H, chain_T, w, y_rho, y_K.  Blocks as hh_rb_values_vjp.
extern "C" int hh_rb_values_vjp_curve(const float* params, const float* coef, const float* lpack,
                                      const float* dpack, const int* sobol, const float* ct,
                                      double* partials, long long n_paths, int steps,
                                      int antithetic, unsigned seed, unsigned device_id,
                                      long long point_offset, int grid, float* slab,
                                      void* stream) {
  const size_t smem = rb_curve_smem(steps, sobol != nullptr);
  const auto kernel = wide(steps) ? rb_vjp_curve_kernel<true> : rb_vjp_curve_kernel<false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = wide(steps) ? grid : (n_paths + kThreads - 1) / kThreads;
  kernel<<<(unsigned)blocks, kChunkThreads, smem, (cudaStream_t)stream>>>(
      params, reinterpret_cast<const float4*>(coef), reinterpret_cast<const float4*>(lpack),
      reinterpret_cast<const float4*>(dpack), sobol, ct, partials, n_paths, steps, antithetic,
      seed, device_id, point_offset, slab);
  return (int)cudaGetLastError();
}

// K19's sums of (value + antithetic value) per strike over the pairs
// [0, total_pairs): ks is (m, 2) float32 (log(f_base / K), K), m at most
// kMaxStrikes (the caller launches wider smiles a chunk of strikes at a
// time), partials (m, grid) float64; grid is K15's (hh_rb_price_grid).
extern "C" int hh_rb_smile(const float* params, const float* coef, const float* lpack,
                           const int* sobol, const float* ks, int m, double* partials, int grid,
                           long long total_pairs, int steps, unsigned seed, unsigned device_id,
                           long long point_offset, float* slab, void* stream) {
  if (m < 1 || m > kMaxStrikes) return (int)cudaErrorInvalidValue;
  const size_t smem =
      rb_chunk_smem(steps, sobol != nullptr) + sizeof(float) * m * kThreads;
  const auto kernel = wide(steps) ? rb_smile_kernel<true> : rb_smile_kernel<false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kChunkThreads, smem, (cudaStream_t)stream>>>(
      params, reinterpret_cast<const float4*>(coef), reinterpret_cast<const float4*>(lpack), sobol,
      reinterpret_cast<const float2*>(ks), m, partials, total_pairs, steps, seed, device_id,
      point_offset, slab);
  return (int)cudaGetLastError();
}

// The occupancy on the current device at `steps` steps, with or without
// the Sobol' table, of the block-cooperative kernels: out =
// (threads a block, resident blocks per SM, SMs, dynamic shared bytes,
// static shared bytes, registers a thread, local (spill) bytes a thread).
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

// K14's.
extern "C" int hh_rb_values_occupancy(int steps, int qmc, int* out) {
  return chunk_occupancy(wide(steps) ? rb_values_kernel<true> : rb_values_kernel<false>,
                         rb_chunk_smem(steps, qmc != 0), out);
}

// K15's.
extern "C" int hh_rb_price_occupancy(int steps, int qmc, int* out) {
  return chunk_occupancy(wide(steps) ? rb_price_kernel<true> : rb_price_kernel<false>,
                         rb_chunk_smem(steps, qmc != 0), out);
}

// K16's.
extern "C" int hh_rb_greeks_occupancy(int steps, int qmc, int* out) {
  return chunk_occupancy(wide(steps) ? rb_greeks_kernel<true> : rb_greeks_kernel<false>,
                         rb_greeks_smem(steps, qmc != 0), out);
}

// K17's.
extern "C" int hh_rb_vjp_occupancy(int steps, int qmc, int* out) {
  return chunk_occupancy(wide(steps) ? rb_vjp_kernel<true> : rb_vjp_kernel<false>,
                         rb_greeks_smem(steps, qmc != 0), out);
}

// K18's.
extern "C" int hh_rb_vjp_curve_occupancy(int steps, int qmc, int* out) {
  return chunk_occupancy(wide(steps) ? rb_vjp_curve_kernel<true> : rb_vjp_curve_kernel<false>,
                         rb_curve_smem(steps, qmc != 0), out);
}

// One resident wave: SMs x blocks an SM, from an occupancy's out[7].
static int resident_wave(int err, const int* occ, int* grid) {
  *grid = occ[2] * (occ[1] > 0 ? occ[1] : 1);
  return err;
}

// The price kernels' grid (K15; K16, which walks K15's trips for its price
// to equal K15's, and holds as many blocks an SM; K19): one resident wave
// of K15.
extern "C" int hh_rb_price_grid(int steps, int qmc, int* grid) {
  int occ[7];
  return resident_wave(hh_rb_price_occupancy(steps, qmc, occ), occ, grid);
}

// K14's grid: one resident wave of K14.
extern "C" int hh_rb_values_grid(int steps, int qmc, int* grid) {
  int occ[7];
  return resident_wave(hh_rb_values_occupancy(steps, qmc, occ), occ, grid);
}
