"""Marginal cost of each phase of a Heston kernel (K1 the Euler terminal
prices, K2 the exact-mixing values, K3 the exact price, K5 the QE-M
terminal prices, K6 the QE-M price, K7 the QE mixing values, K8 the QE
mixing price, K10 the QE price + 7 greeks, K11 the values' VJP), of a QE mixing
surface kernel (K9, or K12 with its Jacobian) or of a rough-Bergomi kernel
(K14 values, K16 price + greeks, K17 the values' VJP) on the card.

For each phase the script copies a tree's package (``--root``, default the
repository) to ``build/phase_costs/<kernel> <phase>/``, rewrites the
kernel's source there so that the phase does almost no work (the rest still
consumes what the phase would have produced), and times the copy with
``chip_smoke.py --times OUT --root COPY --only KERNEL``.  A phase's marginal
cost is the full kernel's time less the copy's.  The full tree is timed
before and after the copies, in one call on one card.  A rewritten copy
computes wrong values: it exists only to be timed.

Run on a GPU host, from the repository root:

    python3 scripts/phase_costs.py OUT.json [--root DIR]
        [--kernel K1|K2|K3|K5|K6|K7|K8|K9|K10|K11|K12|K14|K16|K17]

Each rewrite names the source text it replaces (the kernel before its
redesign, or after it); a tree with neither raises, so the phases are
always the ones named here.  An edit whose replacement is its own text is
a guard: its alternative applies only to a tree that holds that text once.
"""

import argparse
import json
import pathlib
import shutil
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]

# Per phase, alternatives: the rewrite of the kernel before its redesign
# (K9 and K12 one close per strike and MixStream's draw; K14, K16 and K17
# one pair a thread), then of the kernel after it, tried from the last.  An
# alternative is a list of edits (file under hedgehog_tpu_torch/csrc, text,
# replacement); a text given as (start, end) is the source from start up to
# end.
# K9 and K12 since K12's redesign: one draw (draw_steps) for both, rewritten
# to a hash of the pair and step (each kernel is timed on its own)
_SURFACE_DRAW = [
    ("heston_surface.cu",
     ("  if (sobol) {\n    for (int s = step; s < end; ++s) {\n"
      "      const int* rows = sobol + 2 * s * (hh::kSobolBits + 1);\n      if constexpr (kSplit) {",
      "// K9: the pair's value at every point"),
     "  for (int s = step; s < end; ++s) {\n"
     "    const uint32_t h = (uint32_t)pair * 2654435761u + s * 40503u;\n"
     "    const float u = (float)(h >> 8) * (1.0f / 16777216.0f);\n"
     "    advance(4.0f * u - 2.0f, u);\n  }\n}\n\n"),
    ("heston_surface.cu", "    if (kStaged && table) stage_high(table, 2 * total_steps, p0, hw);\n",
     "")]
# the same since draw_steps moved to heston_qe.cuh (shared with K10)
_SHARED_DRAW = [
    ("heston_qe.cuh",
     ("  if (sobol) {\n    for (int s = step; s < end; ++s) {\n"
      "      const int* rows = sobol + 2 * s * (kSobolBits + 1);\n      if constexpr (kSplit) {",
      "// The parameter struct P (floats only)"),
     _SURFACE_DRAW[0][2]),
    _SURFACE_DRAW[1]]

# the same since the stream is draw_steps' template argument (K9 and K12
# through heston_surface.cu draw_segment)
_SHARED_DRAW_T = [
    ("heston_qe.cuh",
     ("  if constexpr (kQmc && kSplit) {\n",
      "// The (z_v, z_x, u) of each of `steps` steps of one pair"),
     _SURFACE_DRAW[0][2]),
    _SURFACE_DRAW[1]]
_IND = " " * 35  # the surface kernels' draw_segment lambdas

K9_PHASES = {
    "walk": [
        [("heston_surface.cu",
          "        hh::mix_advance(v, iv, j, z, u, c);\n"
          "        hh::mix_advance(va, iva, ja, -z, 1.0f - u, c);\n",
          "        iv += c.half_dt * u;\n        j += z;\n"
          "        iva += c.half_dt * (1.0f - u);\n        ja -= z;\n")],
        [("heston_surface.cu",
          "      hh::mix_advance(v, iv, j, z, u, sc);\n"
          "      hh::mix_advance(va, iva, ja, -z, 1.0f - u, sc);\n",
          "      iv += sc.half_dt * u;\n      j += z;\n"
          "      iva += sc.half_dt * (1.0f - u);\n      ja -= z;\n")],
        [("heston_surface.cu",
          "                           hh::mix_advance(v, iv, j, z, u, sc);\n"
          "                           hh::mix_advance(va, iva, ja, -z, 1.0f - u, sc);\n",
          "                           iv += sc.half_dt * u;\n                           j += z;\n"
          "                           iva += sc.half_dt * (1.0f - u);\n"
          "                           ja -= z;\n")],
        [("heston_surface.cu",
          f"{_IND}hh::mix_advance(v, iv, j, z, u, sc);\n"
          f"{_IND}hh::mix_advance(va, iva, ja, -z, 1.0f - u, sc);\n",
          f"{_IND}iv += sc.half_dt * u;\n{_IND}j += z;\n"
          f"{_IND}iva += sc.half_dt * (1.0f - u);\n{_IND}ja -= z;\n")],
    ],
    "draw": [
        [("heston_surface.cu",
          "        ds.draw(step, z, u);\n        hh::mix_advance(v, iv, j, z, u, c);\n",
          "        {\n"
          "          const uint32_t h = (uint32_t)ds.pair * 2654435761u + step * 40503u;\n"
          "          u = (float)(h >> 8) * (1.0f / 16777216.0f);\n"
          "          z = 4.0f * u - 2.0f;\n        }\n"
          "        hh::mix_advance(v, iv, j, z, u, c);\n")],
        [("heston_surface.cu",
          ("    if (live && sobol) {\n", "    step = end;\n"),
          "    for (int s = step; live && s < end; ++s) {\n"
          "      const uint32_t h = (uint32_t)pair * 2654435761u + s * 40503u;\n"
          "      const float u = (float)(h >> 8) * (1.0f / 16777216.0f);\n"
          "      advance(4.0f * u - 2.0f, u);\n    }\n"),
         ("heston_surface.cu",
          "      if (table) stage_high(table, 2 * total_steps, p0, hw);\n", "")],
        _SURFACE_DRAW,
        _SHARED_DRAW,
        _SHARED_DRAW_T,
    ],
    "closes": [
        [("heston_surface.cu",
          "          live ? hh::cond_bs_value(iv, j, close[p]) + "
          "hh::cond_bs_value(iva, ja, close[p]) : 0.0f;\n",
          "          live ? (iv + j + iva + ja) * close[p].strike : 0.0f;\n")],
        [("heston_surface.cu",
          ("    const hh::CloseGroup g = hh::close_group(iv, j, close[i * m]);\n",
           "      hh::warp_accumulate(y, wacc, n_cols, p);\n"),
          "    for (int k = 0; k < m; ++k) {\n      const int p = i * m + k;\n"
          "      const float y = live ? (iv + j + iva + ja) * close[p].strike : 0.0f;\n")],
    ],
    "sums": [
        [("heston_surface.cu",
          "      hh::warp_accumulate(y, wacc, n_cols, p);\n    }\n  }\n}\n\n// One path's state",
          "      if (y == -1.0f) wacc[p] = y;\n    }\n  }\n}\n\n// One path's state")],
    ],
}

K16_PHASES = {
    "draw": [
        [("rbergomi.cu",
          "                                             float ct_p, float ct_m, float* acc) {\n"
          "  draw_xi(xs, pair, table, s, seed, device_id, point_offset, threadIdx.x);\n",
          "                                             float ct_p, float ct_m, float* acc) {\n"
          "  for (int r = 0; r < s.xi_rows; ++r) {\n"
          "    xs[r * kThreads + threadIdx.x] =\n"
          "        r < 2 * s.n - 1 ? (float)((pair + r) & 7) * 0.125f - 0.4375f : 0.0f;\n"
          "  }\n")],
        [("rbergomi.cu",
          "  draw_xi<kSplit>(xs, base + t % kThreads, table, s, seed, device_id, point_offset, "
          "t % kThreads,\n"
          "                  t / kThreads, kChunkThreads / kThreads);\n",
          "  for (int r = t / kThreads; r < s.xi_rows; r += kChunkThreads / kThreads) {\n"
          "    xs[r * kThreads + t % kThreads] =\n"
          "        r < 2 * s.n - 1 ? (float)((base + t + r) & 7) * 0.125f - 0.4375f : 0.0f;\n"
          "  }\n")],
    ],
    "tangent product": [
        [("rbergomi.cu",
          "      if (kTan) {\n        load_col(dpack, tile * s.zcols + c, v);\n"
          "        add_col<0>(v, xa, xb, accd);\n      }\n", ""),
         ("rbergomi.cu",
          "  if (kTan) {\n    load_col(dpack, tile * s.zcols + c, v);\n"
          "    add_col<kCC>(v, xa, xb, accd);\n  }\n", "")],
        [("rbergomi.cu",
          "      chunk_product<2>(xs, zd ? dpack : lpack, s, chunk, zd ? dbuf : xbuf);\n",
          "      if (!zd) chunk_product<2>(xs, lpack, s, chunk, xbuf);\n")],
    ],
    "steps": [
        [("rbergomi.cu",
          "    rb_step<kTan>(xs, p, coef, k, z, zd, anti, gp, gm);\n",
          "    gp.iv += z;\n    gp.div_h += zd;\n    gm.j += xs[k * kThreads + threadIdx.x];\n")],
        [("rbergomi.cu",
          "    chunk_walk_tan<kRows>(xs, xbuf, dbuf, p, coef, s, chunk, mirror, slot, g);\n",
          "    g.iv += xbuf[slot];\n    g.div_h += dbuf[slot];\n")],
    ],
    "closes": [
        [("rbergomi.cu",
          "  group_rows<kVjp>(gp, iv, j, s0dwd0, p, rp);\n",
          "  {\n"
          "    const float t_[7] = {iv, j, gp.div_eta, gp.dj_eta, gp.div_h, gp.djh_g, s0dwd0};\n"
          "    for (int q_ = 0; q_ < kCols; ++q_) rp[q_] = t_[q_];\n  }\n"),
         ("rbergomi.cu",
          "    group_rows<kVjp>(gm, iv, j, -s0dwd0, p, rm);\n",
          "    {\n      const float t_[7] = {iv, j, gm.div_eta, gm.dj_eta, gm.div_h, gm.djh_g,\n"
          "                           s0dwd0};\n"
          "      for (int q_ = 0; q_ < kCols; ++q_) rm[q_] = t_[q_];\n    }\n")],
        [("rbergomi.cu",
          ("    add_pair_rows<false, kGreekCols>(",
           "  }\n  for (int k = 0; k < kGreekCols; ++k) {\n"),
          "    if (!mirror && base + slot < total_pairs) {\n"
          "      const float t_[kGreekCols] = {g.iv + gm.iv, g.j + gm.j, g.div_eta + gm.div_eta,\n"
          "                                    g.dj_eta + gm.dj_eta, g.div_h + gm.div_h + x0,\n"
          "                                    g.djh_g + gm.djh_s};\n"
          "      for (int q_ = 0; q_ < kGreekCols; ++q_) acc[q_] += t_[q_];\n    }\n")],
    ],
}

# The rough-Bergomi kernels' shared rewrites: the chunked trips' draw (K14,
# K16, K17 after their redesign) and, one pair a thread, the Volterra
# product of rb_walk (K14, K17) and its steps.
_TRIP_DRAW = K16_PHASES["draw"][1]
_RB_WALK_PRODUCT = [
    ("rbergomi.cu",
     ("    const int j0 = tile * kTile;\n    for (int c = 0; c < j0; ++c) {\n",
      "    static_assert(kTile == 8"),
     "    const int j0 = tile * kTile;\n"
     "#pragma unroll\n"
     "    for (int r = 0; r < kTile; ++r) {\n"
     "      acc[r] = xs[(s.n + j0 + r) * kThreads + t];\n"
     "      accd[r] = 0.5f * acc[r];\n    }\n")]
_CHUNK_FILL = ("{\n        xbuf[i_] = xs[(s.n * kThreads + i_) % (s.xi_rows * kThreads)];\n"
               "        dbuf[i_] = 0.5f * xbuf[i_];\n      }\n")
# guards: text only the redesigned K14 and K17 hold
_K14_NEW = ("rbergomi.cu", "rb_trip_factors<true>(", "rb_trip_factors<true>(")
_K17_NEW = ("rbergomi.cu", "add_pair_rows<true, kVjpCols>(g, gm,",
            "add_pair_rows<true, kVjpCols>(g, gm,")

K14_PHASES = {
    "draw": [
        [("rbergomi.cu",
          "                                               float& val, float& val_a) {\n"
          "  draw_xi(xs, pair, table, s, seed, device_id, point_offset, threadIdx.x);\n",
          "                                               float& val, float& val_a) {\n"
          "  for (int r = 0; r < s.xi_rows; ++r) {\n"
          "    xs[r * kThreads + threadIdx.x] =\n"
          "        r < 2 * s.n - 1 ? (float)((pair + r) & 7) * 0.125f - 0.4375f : 0.0f;\n"
          "  }\n")],
        _TRIP_DRAW + [_K14_NEW],
    ],
    "product": [
        _RB_WALK_PRODUCT,
        [("rbergomi.cu",
          "    chunk_product<kChunkWarps>(xs, lpack, s, chunk, xbuf);\n    __syncthreads();\n"
          "    chunk_walk(",
          "    for (int i_ = threadIdx.x; i_ < kChunkRows * kThreads; i_ += kChunkThreads) {\n"
          "      xbuf[i_] = xs[(s.n * kThreads + i_) % (s.xi_rows * kThreads)];\n    }\n"
          "    __syncthreads();\n    chunk_walk("), _K14_NEW],
    ],
    "steps": [
        K16_PHASES["steps"][0],
        [("rbergomi.cu",
          "    chunk_walk(xs, xbuf, p, coef, s, chunk, mirror, slot, g);\n",
          "    g.iv += xbuf[slot];\n    g.j += xbuf[kThreads + slot];\n"), _K14_NEW],
    ],
    "closes": [
        [("rbergomi.cu", "  val = hh::cond_bs_value(iv, j, p.close);\n",
          "  val = (iv + j) * p.close.strike;\n"),
         ("rbergomi.cu", "    val_a = hh::cond_bs_value(iv, j, p.close);\n",
          "    val_a = (iv + j) * p.close.strike;\n")],
        [("rbergomi.cu",
          "    const float val = hh::cond_bs_value(iv, j, p.close);\n    if (base + slot < n_paths",
          "    const float val = (iv + j) * p.close.strike;\n    if (base + slot < n_paths"),
         _K14_NEW],
    ],
}

K17_PHASES = {
    "draw": [K16_PHASES["draw"][0], _TRIP_DRAW + [_K17_NEW]],
    "product": [
        _RB_WALK_PRODUCT,
        [("rbergomi.cu",
          "      chunk_product<2>(xs, zd ? dpack : lpack, s, chunk, zd ? dbuf : xbuf);\n",
          "      for (int i_ = threadIdx.x; i_ < kRows * kThreads; i_ += kChunkThreads) "
          + _CHUNK_FILL), _K17_NEW],
    ],
    "steps": [K16_PHASES["steps"][0], K16_PHASES["steps"][1] + [_K17_NEW]],
    # add_pair_rows: K17's close one pair a thread and on the chunked trips
    "closes": [K16_PHASES["closes"][0]],
}

K12_PHASES = {
    "draw": [
        [("heston_surface.cu",
          "        ds.draw(step, z, u);\n        tan_step_surface(s, z, u, c, dc);\n",
          "        {\n"
          "          const uint32_t h = (uint32_t)ds.pair * 2654435761u + step * 40503u;\n"
          "          u = (float)(h >> 8) * (1.0f / 16777216.0f);\n"
          "          z = 4.0f * u - 2.0f;\n        }\n"
          "        tan_step_surface(s, z, u, c, dc);\n")],
        _SURFACE_DRAW,
        _SHARED_DRAW,
        _SHARED_DRAW_T,
    ],
    "tangent walk": [
        [("heston_surface.cu",
          "        tan_step_surface(s, z, u, c, dc);\n"
          "        tan_step_surface(sa, -z, 1.0f - u, c, dc);\n",
          "        s.iv += c.half_dt * u;\n        s.j += z;\n        s.div[k & 3] += z;\n"
          "        sa.iv += c.half_dt * (1.0f - u);\n        sa.j -= z;\n"
          "        sa.div[k & 3] -= z;\n")],
        [("heston_surface.cu",
          "                           tan_step_surface(s, z, u, sc, dc);\n"
          "                           tan_step_surface(sa, -z, 1.0f - u, sc, dc);\n",
          "                           s.iv += sc.half_dt * u;\n                           s.j += z;\n"
          "                           s.div[0] += z;\n"
          "                           sa.iv += sc.half_dt * (1.0f - u);\n"
          "                           sa.j -= z;\n                           sa.div[0] -= z;\n")],
        [("heston_surface.cu",
          f"{_IND}tan_step_surface(s, z, u, sc, dc);\n"
          f"{_IND}tan_step_surface(sa, -z, 1.0f - u, sc, dc);\n",
          f"{_IND}s.iv += sc.half_dt * u;\n{_IND}s.j += z;\n{_IND}s.div[0] += z;\n"
          f"{_IND}sa.iv += sc.half_dt * (1.0f - u);\n{_IND}sa.j -= z;\n"
          f"{_IND}sa.div[0] -= z;\n")],
    ],
    "closes": [
        [("heston_surface.cu", (f"        const hh::BsPartials b = hh::{close};\n",
                                "      }\n#pragma unroll\n      for (int q = 0; q < kJacCols;"),
          "        const float kp = close[p].strike;\n"
          "        col[0] = (s.iv + s.j + sa.iv + sa.j) * kp;\n"
          "#pragma unroll\n"
          "        for (int d = 0; d < kDirs; ++d) {\n"
          "          col[1 + d] = s.div[d] * kp + dj[d] + sa.div[d] * kp + dja[d];\n"
          "        }\n"
          "        col[5] = s.j * kp;\n        col[6] = sa.j * kp;\n")]
        for close in ("cond_bs_partials(s.iv, s.j, close[p])",
                      "close_partials<false>(g, s.iv, s.j, close[p])")
    ],
    "sums": [
        [("heston_surface.cu",
          "      for (int q = 0; q < kJacCols; ++q) hh::warp_accumulate(col[q], wacc, n_cols, "
          "p * kJacCols + q);\n",
          "      for (int q = 0; q < kJacCols; ++q) {\n"
          "        if (col[q] == -1.0f) wacc[p * kJacCols + q] = col[q];\n      }\n")],
    ],
}

# K3: the exact segment's parts (exact_segment, shared with K2 and K4; one
# text in every tree), then K3's draw, close and sums: one pair a thread,
# then two threads a pair, then that walk shared with K2 (exact_group)
_HASH_DRAW = ("const uint32_t h_ = (uint32_t)pair * 2654435761u + s * 40503u;\n"
              "{i}{d}u_pois = (float)(h_ >> 8) * (1.0f / 16777216.0f);\n"
              "{i}{d}z_gam = 4.0f * {d}u_pois - 2.0f;\n{i}{d}u_boost = 1.0f - {d}u_pois;\n"
              "{i}{d}z_iv = -{d}z_gam;\n")
K3_PHASES = {
    "draw": [
        [("heston_exact.cu",
          "    exact_draw(pair, idx, sobol, s, seed, device_id, u_pois, z_gam, u_boost, z_iv);\n",
          "    {\n      " + _HASH_DRAW.format(i="      ", d="") + "    }\n")],
        [("heston_exact.cu",
          "      const ExactDraw d =\n          exact_draw_shared<kStaged>(pair, idx, table, s, "
          "seed, device_id, odd, next, hw, c);\n",
          "      ExactDraw d;\n      {\n        " + _HASH_DRAW.format(i="        ", d="d.")
          + "      }\n"),
         ("heston_exact.cu", "    if (kStaged && table) hh::stage_high(table, 4 * segments, p0, hw);\n",
          "")],
        [("heston_exact.cu",
          "    const ExactDraw d =\n        exact_draw_shared<kStaged>(pair, idx, table, s, "
          "seed, device_id, odd, next, hw, c);\n",
          "    ExactDraw d;\n    {\n      " + _HASH_DRAW.format(i="      ", d="d.") + "    }\n"),
         ("heston_exact.cu",
          "  if (kStaged && table) hh::stage_high(table, 4 * segments, p0, hw);\n", "")],
    ],
    "Poisson count": [
        [("heston_exact.cu", ("  if (u_pois < 0.0f) {\n", "\n  // Gamma(d/2 + N, 2c)"),
          "  n = floorf(fabsf(u_pois) * mu * 2.0f);\n")],
    ],
    "gamma quantiles": [
        [("heston_exact.cu",
          ("__device__ __forceinline__ float gamma_qtl(float alpha, float z) {\n",
           "// The Poisson(mu) count at u = 1 - w"),
          "__device__ __forceinline__ float gamma_qtl(float alpha, float z) {\n"
          "  return fmaxf(alpha + z * sqrtf(alpha), 0.01f * alpha);\n}\n\n")],
    ],
    "Bessel fraction": [
        [("heston_exact.cu",
          "    for (int m = kCfIters; m >= 1; --m) r = z * hh::rcp(2.0f * (c.nu + (float)m) + z * r);\n",
          "    r = z * hh::rcp(2.0f * (c.nu + 1.0f) + z);\n")],
    ],
    "close": [
        [("heston_exact.cu",
          "  val = exact_close(v, iv, c);\n  val_a = antithetic ? exact_close(va, iva, c) : 0.0f;\n",
          "  val = (v + iv) * c.close.strike;\n"
          "  val_a = antithetic ? (va + iva) * c.close.strike : 0.0f;\n")],
        [("heston_exact.cu", "    const float val = exact_close(v, iv, sp);\n",
          "    const float val = (v + iv) * sp.close.strike;\n")],
        [("heston_exact.cu", "  return exact_close(v, iv, sp);\n",
          "  return (v + iv) * sp.close.strike;\n")],
    ],
    "sums": [
        [("heston_exact.cu", "    acc += val + val_a;\n  }\n  red[threadIdx.x] = (double)acc;\n",
          "    if (val + val_a == -1.0f) acc = 1.0f;\n  }\n  red[threadIdx.x] = (double)acc;\n")],
        [("heston_exact.cu",
          "    const float val_a = __shfl_xor_sync(0xffffffffu, val, 1);\n"
          "    if (!odd && g < total_pairs) acc += val + val_a;\n",
          "    if (val == -1.0f) acc = 1.0f;\n")],
        [("heston_exact.cu",
          "    const float val_a = __shfl_xor_sync(0xffffffffu, val, 1);\n"
          "    if (!odd && base + q < total_pairs) acc += val + val_a;\n",
          "    if (val == -1.0f) acc = 1.0f;\n")],
    ],
}

# K2 (antithetic): one pair a thread (exact_pair), then K3's walk
# (exact_group); the segment's parts are K3's
K2_PHASES = {
    "draw": [K3_PHASES["draw"][0], K3_PHASES["draw"][2]],
    "Poisson count": K3_PHASES["Poisson count"],
    "gamma quantiles": K3_PHASES["gamma quantiles"],
    "Bessel fraction": K3_PHASES["Bessel fraction"],
    "close": [K3_PHASES["close"][0], K3_PHASES["close"][2]],
    "store": [
        [("heston_exact.cu", "  out[i] = val;\n  if (antithetic) out[n_paths + i] = val_a;\n",
          "  if (val + val_a == -1.0f) out[i] = val;\n")],
        [("heston_exact.cu",
          "  if (g < n_paths) out[((threadIdx.x & 1) ? n_paths : 0) + g] = val;\n",
          "  if (val == -1.0f) out[g] = val;\n")],
    ],
}

# K1: a Philox block per step's parity test, then one loop body per block
# (two calls); Box-Muller, the Euler step and the close are one text in
# both trees
_EULER_HASH = ("hh::U4{{(uint32_t)i * 2654435761u + {k} * 40503u, (uint32_t)i * 2246822519u ^ {k}, "
               "(uint32_t)i + {k} * 3266489917u, (uint32_t)i ^ {k} * 668265263u}}")
_PHILOX_K = "hh::philox_block((unsigned long long)i, (uint32_t){k}, seed, device_id)"
K1_PHASES = {
    "Philox": [
        [("heston_euler.cu", _PHILOX_K.format(k="(s >> 1)"), _EULER_HASH.format(k="(uint32_t)s"))],
        [("heston_euler.cu", _PHILOX_K.format(k="k"), _EULER_HASH.format(k="(uint32_t)k")),
         ("heston_euler.cu", _PHILOX_K.format(k="(steps / 2)"),
          _EULER_HASH.format(k="(uint32_t)steps"))],
    ],
    "Box-Muller": [
        [("heston_euler.cu", "hh::box_muller(b0, b1, z1, z2);",
          "z1 = (float)(int)b0 * 4.6566e-10f;\n  z2 = (float)(int)b1 * 4.6566e-10f;")],
    ],
    "Euler advance": [
        [("heston_euler.cu", ("  const float v_plus = fmaxf(v, 0.0f);\n", "  x = x2;\n"),
          "  const float x2 = x + z1 * c.dt;\n  const float v2 = v + z2 * c.dt;\n")],
    ],
    "expf and store": [
        [("heston_euler.cu", ("  out[i] = expf(x);\n", "\n}\n"),
          "  if (x + xa == -1.0f) out[i] = x;")],
    ],
}

# K10: one pair a thread through hh::mix_draws, then on K9's split draw
# K10's draw rewritten to a hash of the pair and step
_K10_HASH = ("    for (int s_ = 0; s_ < steps; ++s_) {\n"
             "      const uint32_t h_ = (uint32_t)g * 2654435761u + s_ * 40503u;\n"
             "      const float u = (float)(h_ >> 8) * (1.0f / 16777216.0f), z = 4.0f * u - 2.0f;\n"
             "      hh::tan_step(s, z, u, sp, stab);\n"
             "      hh::tan_step(sa, -z, 1.0f - u, sp, stab);\n    }\n")
_IND10 = " " * 41  # K10's draw_steps lambda since the stream is its template argument
K10_PHASES = {
    "draw": [
        [("heston_qe_greeks.cu",
          "    hh::mix_draws((unsigned long long)g, table, steps, seed, device_id, point_offset,\n"
          "                  [&](float z, float u) {\n"
          "                    hh::tan_step(s, z, u, sp, stab);\n"
          "                    hh::tan_step(sa, -z, 1.0f - u, sp, stab);\n"
          "                  });\n",
          "    for (int s_ = 0; s_ < steps; ++s_) {\n"
          "      const uint32_t h_ = (uint32_t)g * 2654435761u + s_ * 40503u;\n"
          "      const float u = (float)(h_ >> 8) * (1.0f / 16777216.0f), z = 4.0f * u - 2.0f;\n"
          "      hh::tan_step(s, z, u, sp, stab);\n"
          "      hh::tan_step(sa, -z, 1.0f - u, sp, stab);\n    }\n")],
        [("heston_qe_greeks.cu",
          ("    hh::draw_steps<kStaged>((unsigned long long)g, (uint32_t)(point_offset + g), table,",
           "    // the close shares the vega's exponential"),
          "    for (int s_ = 0; s_ < steps; ++s_) {\n"
          "      const uint32_t h_ = (uint32_t)g * 2654435761u + s_ * 40503u;\n"
          "      const float u = (float)(h_ >> 8) * (1.0f / 16777216.0f), z = 4.0f * u - 2.0f;\n"
          "      hh::tan_step(s, z, u, sp, stab);\n"
          "      hh::tan_step(sa, -z, 1.0f - u, sp, stab);\n    }\n"),
         ("heston_qe_greeks.cu", "    if (kStaged && kQmc) hh::stage_high(table, 2 * steps, p0, hw);\n",
          "")],
        [("heston_qe_greeks.cu",
          ("    hh::draw_steps<kQmc == 1, kStaged>((unsigned long long)g,",
           "    // the close shares the vega's exponential"),
          _K10_HASH),
         ("heston_qe_greeks.cu", "    if (kStaged && kQmc) hh::stage_high(table, 2 * steps, p0, hw);\n",
          "")],
    ],
    "tangent walk": [
        [("heston_qe_greeks.cu",
          "                    hh::tan_step(s, z, u, sp, stab);\n"
          "                    hh::tan_step(sa, -z, 1.0f - u, sp, stab);\n",
          "                    s.iv += sp.half_dt * u;\n                    s.j += z;\n"
          "                    sa.iv += sp.half_dt * (1.0f - u);\n                    sa.j -= z;\n"
          "                    for (int d_ = 0; d_ < kGreekDirs; ++d_) {\n"
          "                      s.dv[d_] = z;\n                      s.s[d_] += u;\n"
          "                      sa.dv[d_] = -z;\n                      sa.s[d_] += 1.0f - u;\n"
          "                    }\n")],
        [("heston_qe_greeks.cu",
          "                              hh::tan_step(s, z, u, sp, stab);\n"
          "                              hh::tan_step(sa, -z, 1.0f - u, sp, stab);\n",
          "                              s.iv += sp.half_dt * u;\n                              s.j += z;\n"
          "                              sa.iv += sp.half_dt * (1.0f - u);\n"
          "                              sa.j -= z;\n"
          "                              for (int d_ = 0; d_ < kGreekDirs; ++d_) {\n"
          "                                s.dv[d_] = z;\n                                s.s[d_] += u;\n"
          "                                sa.dv[d_] = -z;\n"
          "                                sa.s[d_] += 1.0f - u;\n"
          "                              }\n")],
        [("heston_qe_greeks.cu",
          f"{_IND10}hh::tan_step(s, z, u, sp, stab);\n"
          f"{_IND10}hh::tan_step(sa, -z, 1.0f - u, sp, stab);\n",
          f"{_IND10}s.iv += sp.half_dt * u;\n{_IND10}s.j += z;\n"
          f"{_IND10}sa.iv += sp.half_dt * (1.0f - u);\n{_IND10}sa.j -= z;\n"
          f"{_IND10}for (int d_ = 0; d_ < kGreekDirs; ++d_) {{\n"
          f"{_IND10}  s.dv[d_] = z;\n{_IND10}  s.s[d_] += u;\n"
          f"{_IND10}  sa.dv[d_] = -z;\n{_IND10}  sa.s[d_] += 1.0f - u;\n"
          f"{_IND10}}}\n")],
    ],
    "close and partials": [
        [("heston_qe_greeks.cu",
          ("    const hh::BsPartials b = hh::cond_bs_partials(s.iv, s.j, sp.close);\n",
           "  }\n  hh::block_sums<kThreads>(acc, red, partials);"),
          "    acc[0] += (s.iv + s.j + sa.iv + sa.j) * sp.close.strike;\n"
          "#pragma unroll\n"
          "    for (int d = 0; d < kGreekDirs; ++d) {\n"
          "      acc[1 + d] += s.s[d] + s.dv[d] + sa.s[d] + sa.dv[d];\n    }\n"
          "    acc[5] += s.j;\n    acc[6] += sa.j;\n")],
        [("heston_qe_greeks.cu",
          ("    const hh::BsPartials b =\n        hh::close_partials<false>(",
           "  }\n  hh::block_sums<kThreads>(acc, red, partials);"),
          "    acc[0] += (s.iv + s.j + sa.iv + sa.j) * sp.close.strike;\n"
          "#pragma unroll\n"
          "    for (int d = 0; d < kGreekDirs; ++d) {\n"
          "      acc[1 + d] += s.s[d] + s.dv[d] + sa.s[d] + sa.dv[d];\n    }\n"
          "    acc[5] += s.j;\n    acc[6] += sa.j;\n")],
    ],
    "sums": [
        [("heston_qe_greeks.cu",
          "    acc[6] += b.y_rho + ba.y_rho;\n  }\n  hh::block_sums<kThreads>(acc, red, partials);\n",
          "    acc[6] += b.y_rho + ba.y_rho;\n  }\n"
          "  if (acc[0] == -1.0f) {\n"
          "    for (int k_ = 0; k_ < kGreekCols; ++k_) partials[k_ * gridDim.x + blockIdx.x] = acc[k_];\n"
          "  }\n")],
    ],
}

# K8: one pair a thread through hh::mix_draws (mix_pair, shared with K7),
# then one body per stream (price_body: K10's split draw under QMC,
# hh::mix_draws under PRNG)
_MIX_HASH = ("for (int s_ = 0; s_ < steps; ++s_) {{\n"
             "{i}  const uint32_t h_ = (uint32_t)pair * 2654435761u + s_ * 40503u;\n"
             "{i}  const float u = (float)(h_ >> 8) * (1.0f / 16777216.0f), z = 4.0f * u - 2.0f;\n")
K8_PHASES = {
    "draw": [
        [("heston_qe.cu",
          "  hh::mix_draws(pair, sobol, steps, seed, device_id, point_offset, [&](float z, float u) {\n"
          "    hh::mix_advance(v, iv, j, z, u, c);\n"
          "    if (antithetic) hh::mix_advance(va, iva, ja, -z, 1.0f - u, c);\n  });\n",
          "  " + _MIX_HASH.format(i="  ") + "    hh::mix_advance(v, iv, j, z, u, c);\n"
          "    if (antithetic) hh::mix_advance(va, iva, ja, -z, 1.0f - u, c);\n  }\n")],
        [("heston_qe.cu",
          ("    if constexpr (kQmc == 1) {\n      float z_odd = 0.0f;\n",
           "    acc[0] += hh::cond_bs_value(iv, j, sp.close)"),
          "    " + _MIX_HASH.format(i="    ").replace("(uint32_t)pair", "(uint32_t)g")
          + "      step(z, u);\n    }\n"),
         ("heston_qe.cu", "    if (kStaged && kQmc) hh::stage_high(table, 2 * steps, p0, hw);\n",
          "")],
    ],
    "QE step": [
        [("heston_qe.cu",
          "    hh::mix_advance(v, iv, j, z, u, c);\n"
          "    if (antithetic) hh::mix_advance(va, iva, ja, -z, 1.0f - u, c);\n",
          "    iv += c.half_dt * u;\n    j += z;\n"
          "    if (antithetic) {\n      iva += c.half_dt * (1.0f - u);\n      ja -= z;\n    }\n")],
        [("heston_qe.cu",
          "      hh::mix_advance(v, iv, j, z, u, sp);\n"
          "      hh::mix_advance(va, iva, ja, -z, 1.0f - u, sp);\n    };\n",
          "      iv += sp.half_dt * u;\n      j += z;\n"
          "      iva += sp.half_dt * (1.0f - u);\n      ja -= z;\n    };\n")],
    ],
    "close": [
        [("heston_qe.cu",
          "  val = hh::cond_bs_value(iv, j, c.close);\n"
          "  val_a = antithetic ? hh::cond_bs_value(iva, ja, c.close) : 0.0f;\n",
          "  val = (iv + j) * c.close.strike;\n"
          "  val_a = antithetic ? (iva + ja) * c.close.strike : 0.0f;\n")],
        [("heston_qe.cu",
          "    acc[0] += hh::cond_bs_value(iv, j, sp.close) + hh::cond_bs_value(iva, ja, sp.close);\n",
          "    acc[0] += (iv + j + iva + ja) * sp.close.strike;\n")],
    ],
    "sums": [
        [("heston_qe.cu",
          "    acc[0] += val + val_a;\n  }\n  hh::block_sums<kThreads>(acc, red, partials);\n",
          "    acc[0] += val + val_a;\n  }\n"
          "  if (acc[0] == -1.0f) partials[blockIdx.x] = acc[0];\n")],
        [("heston_qe.cu",
          "  }\n  hh::block_sums<kThreads>(acc, red, partials);\n}\n\n// K8, one body per stream",
          "  }\n  if (acc[0] == -1.0f) partials[blockIdx.x] = acc[0];\n}\n\n"
          "// K8, one body per stream")],
    ],
}

# K6: one pair a thread through hh::qem_draws (qem_pair, shared with K5) in
# both trees; the QE-M step's parts are hh::qem_advance's (hh_device.cuh,
# shared with K5) and the sums (the payoffs and the block tree; the float64
# add stays) one text in both trees
_QEM_V_CHEAP = ("  QeDraw d;\n  d.quad = true;\n  d.a = v * c.e;\n  d.b2 = z_v * z_v;\n"
                "  const float vn = d.a * (1.0f + d.b2);\n  float k0 = c.K0;\n")
K6_PHASES = {
    "draw": [
        [("heston_qe_terminal.cu",
          "  hh::qem_draws(pair, sobol, steps, seed, device_id, point_offset,\n"
          "                [&](float z_v, float z_x, float u) {\n"
          "                  hh::qem_advance(x, v, z_v, z_x, u, c, mcorr);\n"
          "                  if (antithetic) hh::qem_advance(xa, va, -z_v, -z_x, 1.0f - u, c, "
          "mcorr);\n                });\n",
          "  " + _MIX_HASH.format(i="  ").replace("z = 4.0f", "z_v = 4.0f")
          + "    const float z_x = 1.0f - 2.0f * u;\n"
          "    hh::qem_advance(x, v, z_v, z_x, u, c, mcorr);\n"
          "    if (antithetic) hh::qem_advance(xa, va, -z_v, -z_x, 1.0f - u, c, mcorr);\n  }\n")],
    ],
    "QE variance draw": [
        [("hh_device.cuh",
          "  QeDraw d;\n  const float vn = qe_v_draw(v, z_v, u, c, d);\n  float k0 = c.K0;\n",
          _QEM_V_CHEAP)],
    ],
    "martingale correction": [
        [("hh_device.cuh",
          ("  if (mcorr) {\n    float log_m;\n", "  const float var_x = "),
          "  if (mcorr) k0 = -c.K1_half_K3 * v;\n")],
    ],
    "log-price update": [
        [("hh_device.cuh",
          "  const float var_x = fmaxf(c.K3 * v + c.K4 * vn, 0.0f);\n"
          "  x = x + c.r_dt + k0 + c.K1 * v + c.K2 * vn + sqrtf(var_x) * z_x;\n",
          "  x = x + k0 + z_x;\n")],
    ],
    "sums": [
        [("heston_qe_terminal.cu",
          "    acc[0] += (double)(fmaxf(expf(x) - sp.strike, 0.0f) + fmaxf(expf(xa) - sp.strike, "
          "0.0f));\n  }\n  hh::block_sums<kThreads>(acc, red, partials);\n",
          "    acc[0] += (double)(x + xa);\n  }\n"
          "  if (acc[0] == -1.0) partials[blockIdx.x] = acc[0];\n")],
    ],
}

# K7: one pair a thread through mix_pair (K8's first alternatives), then
# one build per stream (qe_values_kernel: K8's split draw under QMC,
# hh::mix_draws under PRNG)
_K7_OUT = ("  out[i] = hh::cond_bs_value(iv, j, sp.close);\n"
           "  if (antithetic) out[n_paths + i] = hh::cond_bs_value(iva, ja, sp.close);\n")
K7_PHASES = {
    "draw": [
        K8_PHASES["draw"][0],
        [("heston_qe.cu", ("  if constexpr (kQmc == 1) {\n    float z_odd = 0.0f;\n", _K7_OUT),
          "  " + _MIX_HASH.format(i="  ").replace("(uint32_t)pair", "(uint32_t)i")
          + "    step(z, u);\n  }\n"),
         ("heston_qe.cu",
          "  uint32_t* hw = hh::warp_high_words(ssob, 2 * steps);\n"
          "  if (kStaged && kQmc) hh::stage_high(table, 2 * steps, p0, hw);\n",
          "  uint32_t* hw = hh::warp_high_words(ssob, 2 * steps);\n")],
    ],
    "QE step": [
        K8_PHASES["QE step"][0],
        [("heston_qe.cu",
          "    hh::mix_advance(v, iv, j, z, u, sp);\n"
          "    if (antithetic) hh::mix_advance(va, iva, ja, -z, 1.0f - u, sp);\n",
          "    iv += sp.half_dt * u;\n    j += z;\n"
          "    if (antithetic) {\n      iva += sp.half_dt * (1.0f - u);\n      ja -= z;\n    }\n")],
    ],
    "close": [
        K8_PHASES["close"][0],
        [("heston_qe.cu", _K7_OUT,
          "  out[i] = (iv + j) * sp.close.strike;\n"
          "  if (antithetic) out[n_paths + i] = (iva + ja) * sp.close.strike;\n")],
    ],
    "store": [
        [("heston_qe.cu", "  out[i] = val;\n  if (antithetic) out[n_paths + i] = val_a;\n",
          "  if (val + val_a == -1.0f) out[i] = val;\n")],
        [("heston_qe.cu", _K7_OUT,
          "  {\n    const float val = hh::cond_bs_value(iv, j, sp.close);\n"
          "    const float val_a = antithetic ? hh::cond_bs_value(iva, ja, sp.close) : 0.0f;\n"
          "    if (val + val_a == -1.0f) out[i] = val;\n  }\n")],
    ],
}

# K5: one pair a thread through qem_pair (K6's), then one build per stream
# (qem_terminal_kernel: the split QE-M draw under QMC, hh::qem_draws under
# PRNG); the QE-M step's parts and the store (one text) are K6's and the
# parent's
K5_PHASES = {
    "draw": [
        K6_PHASES["draw"][0],
        [("heston_qe_terminal.cu",
          ("  if constexpr (kStaged && kQmc == 1) {\n    hh::qem_split_steps(",
           "  out[i] = expf(x);\n"),
          "  " + _MIX_HASH.format(i="  ").replace("(uint32_t)pair", "(uint32_t)i")
          .replace("z = 4.0f", "z_v = 4.0f")
          + "    step(z_v, 1.0f - 2.0f * u, u);\n  }\n"),
         ("heston_qe_terminal.cu",
          "  uint32_t* hw = hh::warp_high_words(ssob, 3 * steps);\n"
          "  if (kStaged && kQmc) hh::stage_high(table, 3 * steps, p0, hw);\n",
          "  uint32_t* hw = hh::warp_high_words(ssob, 3 * steps);\n")],
    ],
    "QE variance draw": K6_PHASES["QE variance draw"],
    "martingale correction": K6_PHASES["martingale correction"],
    "log-price update": K6_PHASES["log-price update"],
    "expf and store": [
        [("heston_qe_terminal.cu", "  out[i] = expf(x);\n  if (antithetic) out[n_paths + i] = expf(xa);\n",
          "  if (x + xa == -1.0f) out[i] = x;\n")],
    ],
}

# K11: one build for both streams through hh::mix_draws, then one build per
# stream (K7's split draw under QMC, draw_steps' Philox side under PRNG) with
# K10's close; the QE step and the tangent step are tan_step's (heston_qe.cuh,
# shared with K10; one text in both trees): the QE step is V's draw with its
# two tangent coefficients (qe_v_coeffs) and the carries (mix_update), the
# tangent step the five directions' dV and running sums
_K11_HASH = ("    for (int s_ = 0; s_ < steps; ++s_) {\n"
             "      const uint32_t h_ = (uint32_t)i * 2654435761u + s_ * 40503u;\n"
             "      const float u = (float)(h_ >> 8) * (1.0f / 16777216.0f), z = 4.0f * u - 2.0f;\n"
             "      hh::tan_step(s, z, u, sp, stab);\n"
             "      if (antithetic) hh::tan_step(sa, -z, 1.0f - u, sp, stab);\n    }\n")
_K11_SUMS = ("    {\n      const float c0 = ct[i], c1 = antithetic ? ct[n_paths + i] : 0.0f;\n"
             "#pragma unroll\n      for (int d_ = 0; d_ < kVjpDirs; ++d_) {\n"
             "        acc[d_] += c0 * (s.s[d_] + s.dv[d_]) + c1 * (sa.s[d_] + sa.dv[d_]);\n"
             "      }\n      acc[5] += c0 * s.iv + c1 * sa.iv;\n"
             "      acc[6] += c0 * s.j + c1 * sa.j;\n      acc[7] += c0 + c1;\n    }\n")
_K11_TREE = ("  if (acc[0] == -1.0f) {\n"
             "    for (int k_ = 0; k_ < kVjpCols; ++k_) partials[k_ * gridDim.x + blockIdx.x] = acc[k_];\n"
             "  }\n")
K11_PHASES = {
    "draw": [
        [("heston_qe_greeks.cu",
          "    hh::mix_draws((unsigned long long)i, table, steps, seed, device_id, point_offset,\n"
          "                  [&](float z, float u) {\n"
          "                    hh::tan_step(s, z, u, sp, stab);\n"
          "                    if (antithetic) hh::tan_step(sa, -z, 1.0f - u, sp, stab);\n"
          "                  });\n",
          _K11_HASH)],
        [("heston_qe_greeks.cu",
          ("    float z_odd = 0.0f;\n    uint32_t w_odd = 0u;\n"
           "    hh::draw_steps<kQmc == 1, kStaged>((unsigned long long)i,",
           "    weighted_sums(s, ct[i], sp, stab, acc);\n"),
          _K11_HASH),
         ("heston_qe_greeks.cu",
          "  if (kStaged && kQmc) hh::stage_high(table, 2 * steps, p0, hw);\n"
          "  float acc[kVjpCols] = {};\n",
          "  float acc[kVjpCols] = {};\n")],
    ],
    "QE step": [
        [("heston_qe.cuh", "  const float vn = qe_v_coeffs(st.v, z, u, c, cm, cs);\n",
          "  cm = z;\n  cs = u;\n  const float vn = st.v + c.half_dt * z;\n"),
         ("heston_qe.cuh", "  mix_update(st.v, st.iv, st.j, vn, c);\n}\n\n// dIV of direction d",
          "  st.iv += c.half_dt * u;\n  st.j += z;\n  st.v = vn;\n}\n\n// dIV of direction d")],
    ],
    "tangent step": [
        [("heston_qe.cuh",
          ("  const float a_coef = cm * c.e + cs * c.c_s2_v;\n",
           "  mix_update(st.v, st.iv, st.j, vn, c);\n}\n\n// dIV of direction d"),
          "#pragma unroll\n  for (int d = 0; d < kDirs; ++d) {\n"
          "    st.dv[d] = cm;\n    st.s[d] = st.s[d] + cs;\n  }\n")],
    ],
    "close and weighted sums": [
        [("heston_qe_greeks.cu",
          "    weighted_sums(s, ct[i], sp, stab, acc);\n"
          "    if (antithetic) weighted_sums(sa, ct[n_paths + i], sp, stab, acc);\n",
          _K11_SUMS)],
    ],
    "block reduction": [
        [("heston_qe_greeks.cu",
          "  }\n  hh::block_sums<kThreads>(acc, red, partials);\n}\n\nsize_t sobol_smem",
          "  }\n" + _K11_TREE + "}\n\nsize_t sobol_smem")],
        [("heston_qe_greeks.cu", "  }\n  vjp_block_sums(acc, red, partials);\n}\n",
          "  }\n" + _K11_TREE + "}\n")],
    ],
}

PHASES = {"K1": K1_PHASES, "K2": K2_PHASES, "K3": K3_PHASES, "K5": K5_PHASES, "K6": K6_PHASES,
          "K7": K7_PHASES, "K8": K8_PHASES, "K9": K9_PHASES, "K10": K10_PHASES, "K11": K11_PHASES,
          "K12": K12_PHASES, "K14": K14_PHASES, "K16": K16_PHASES, "K17": K17_PHASES}


def _span(text: str, old) -> tuple:
    """(count, start, end) of ``old`` (a text, or (start, end) markers) in
    ``text``."""
    if isinstance(old, str):
        i = text.find(old)
        return text.count(old), i, i + len(old)
    start, end = old
    i = text.find(start)
    j = text.find(end, i + 1) if i >= 0 else -1
    return (text.count(start) if j >= 0 else 0), i, j


def make_copy(root: pathlib.Path, dest: pathlib.Path, alternatives) -> None:
    """``root``'s package at ``dest`` with the last of ``alternatives`` whose
    every text occurs once in ``root``'s sources applied to them."""
    csrc = root / "hedgehog_tpu_torch" / "csrc"
    for edits in reversed(alternatives):
        if all(_span((csrc / name).read_text(), old)[0] == 1 for name, old, _ in edits):
            break
    else:
        raise SystemExit(f"no rewrite of this phase matches the sources under {csrc}")
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(root / "hedgehog_tpu_torch", dest / "hedgehog_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name, old, new in edits:
        path = dest / "hedgehog_tpu_torch" / "csrc" / name
        text = path.read_text()
        _, i, j = _span(text, old)
        path.write_text(text[:i] + new + text[j:])


def times(tree: pathlib.Path, kernel: str, out: pathlib.Path) -> dict:
    """``chip_smoke.py --times`` of ``tree``'s package, ``kernel`` only."""
    cmd = [sys.executable, str(REPO / "chip_smoke.py"), "--times", str(out), "--root", str(tree),
           "--only", kernel]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"{' '.join(cmd)} failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    return json.loads(out.read_text())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out")
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--kernel", choices=sorted(PHASES), default="K9")
    args = ap.parse_args()
    root, work = pathlib.Path(args.root).resolve(), REPO / "build" / "phase_costs"
    work.mkdir(parents=True, exist_ok=True)
    runs = {"full": times(root, args.kernel, work / "full.json")}
    for phase, alternatives in PHASES[args.kernel].items():
        dest = work / f"{args.kernel} {phase}"
        make_copy(root, dest, alternatives)
        runs[f"without {phase}"] = times(dest, args.kernel, work / f"{args.kernel} {phase}.json")
    runs["full again"] = times(root, args.kernel, work / "full again.json")
    keys = [k for k, v in runs["full"].items()
            if k.startswith(args.kernel + " ") and isinstance(v, float)]
    marginal = {}
    for phase in PHASES[args.kernel]:
        for k in keys:
            full = (runs["full"][k] + runs["full again"][k]) / 2
            marginal[f"{phase}: {k}"] = full - runs[f"without {phase}"][k]
    result = {"kernel": args.kernel, "root": str(root), "runs": runs, "marginal_ms": marginal}
    pathlib.Path(args.out).write_text(json.dumps(result, indent=1))
    for k, v in marginal.items():
        print(f"  {k}: {v:.4f} ms")
    for k in keys:
        print(f"  {k}: full {runs['full'][k]:.4f}, again {runs['full again'][k]:.4f}, "
              + ", ".join(f"{name} {run[k]:.4f}" for name, run in runs.items()
                          if name.startswith("without")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
