"""Device deblocking: whole-frame edge filtering as batched segment math.

Batched formulation of the reference's deblock
(/root/reference/libavcodec/vvc/vvc_filter.c:861-1010 drivers and the
filter kernels of vvc_filter_template.c:466-787): the host computes the
per-4-line-segment parameters (boundary strength, beta/tc, max filter
lengths — pixel-independent, reusing the golden Deblocker's BS machinery),
and the device runs one pass per direction: gather every active segment's
16-tap window into a [B, 4, 16] tensor, evaluate the long/strong/weak
decisions and all filter variants vectorized over segments, and
scatter-add the masked deltas.  Per direction the spec guarantees disjoint
writes (normal filters touch <=3 samples a side on an 8-px grid; long
filters require >=32-px blocks), which is exactly what makes this a legal
whole-frame data-parallel pass.

Bit-exactness is pinned against the host golden (ffvvc_jax/deblock.py) by
tests/test_device_filters.py.  LADF streams fall back to the host filter
(LADF's qp offset reads pixel averages mid-pass).
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..deblock import Deblocker

# padded (coef, tc_weight) rows indexed by (ml - 3) // 2  ->  ml in {3,5,7}
_COEF = np.array([[53, 32, 11, 0, 0, 0, 0],
                  [58, 45, 32, 19, 6, 0, 0],
                  [59, 50, 41, 32, 23, 14, 5]], np.int32)
_TCW = np.array([[6, 4, 2, 0, 0, 0, 0],
                 [6, 5, 4, 3, 2, 0, 0],
                 [6, 5, 4, 3, 2, 1, 1]], np.int32)


class _Rasterizer(Deblocker):
    """Collects per-segment filter parameters instead of filtering.
    Segments: luma (px, py, tc, beta, mlp, mlq, hor_ctu_edge) per 4 lines;
    chroma (px, py, tc, beta, mlp, mlq, size) per size lines."""

    def __init__(self, sps, pps, tabs, fb):
        super().__init__(sps, pps, tabs, fb)
        # force the Python per-edge walk (keep the C BS computation)
        self._ptr = dict(self._ptr)
        self._ptr["planes"] = [None, None, None]
        self.luma_segs = []
        self.chroma_segs = {1: [], 2: []}
        self._c_idx = 0

    def _filter_edge(self, c_idx, x, y, end, vertical, n, grid, beta_off,
                     tc_off, bs_tab, hor_ctu_edge):
        self._c_idx = c_idx
        # bypass the C per-edge fast path: temporarily drop the lib so the
        # base routine lands in our recording _filter_luma/_filter_chroma
        lib, self.lib = self.lib, None
        try:
            super()._filter_edge(c_idx, x, y, end, vertical, n, grid,
                                 beta_off, tc_off, bs_tab, hor_ctu_edge)
        finally:
            self.lib = lib

    def _filter_luma(self, plane, px, py, vertical, beta_a, tc_a, mlp_a,
                     mlq_a, hor_ctu_edge):
        bd = self.sps.bit_depth
        for i in range(2):
            tc0 = tc_a[i]
            tc = ((tc0 + (1 << (9 - bd))) >> (10 - bd)) if bd < 10 \
                else (tc0 << (bd - 10))
            if not tc:
                continue
            ex, ey = (px, py + i * 4) if vertical else (px + i * 4, py)
            self.luma_segs.append((ex, ey, tc, beta_a[i] << (bd - 8),
                                   mlp_a[i], mlq_a[i], int(hor_ctu_edge)))

    def _filter_chroma(self, plane, px, py, vertical, beta_a, tc_a, mlp_a,
                       mlq_a, shift):
        bd = self.sps.bit_depth
        size = 2 if shift else 4
        for i in range(8 // size):
            tc0 = tc_a[i]
            tc = ((tc0 + (1 << (9 - bd))) >> (10 - bd)) if bd < 10 \
                else (tc0 << (bd - 10))
            if not tc or not mlp_a[i] or not mlq_a[i]:
                continue
            ex, ey = (px, py + i * size) if vertical else \
                (px + i * size, py)
            self.chroma_segs[self._c_idx].append(
                (ex, ey, tc, beta_a[i] << (bd - 8), mlp_a[i], mlq_a[i],
                 size))


def _pad_pow2(n):
    p = 8
    while p < n:
        p <<= 1
    return p


# ---- luma pass --------------------------------------------------------------

def _luma_math(plane, px, py, tc, beta, mlp, mlq, hce, vertical: bool,
               pix_max: int, row0=0, own_h=None):
    """One whole-frame luma deblock direction: [B] segment params ->
    scatter-added deltas.  Mirrors Deblocker._filter_luma exactly.

    Sharded (row-slab) mode: `plane` is a slab WITH halo rows attached
    above and below, `row0` the frame row of plane[halo-implicit] origin —
    i.e. plane row r holds frame row row0 + r — and `own_h` the number of
    rows this shard owns starting at frame row row0 + halo (deltas outside
    the owned range are masked off; the caller slices the owned rows back
    out).  Defaults keep the single-device whole-frame behaviour."""
    H, W = plane.shape
    B = px.shape[0]
    lines = jnp.arange(4)
    taps = jnp.arange(16)            # tap t: P(7-t) for t<8, Q(t-8) else
    if vertical:
        rows = py[:, None, None] + lines[None, :, None]
        cols = px[:, None, None] - 8 + taps[None, None, :]
    else:
        rows = py[:, None, None] - 8 + taps[None, None, :]
        cols = px[:, None, None] + lines[None, :, None]
    rows = rows - row0
    rows_c = jnp.clip(rows, 0, H - 1)
    cols_c = jnp.clip(cols, 0, W - 1)
    # rows/cols broadcast so dim 1 is the line and dim 2 the tap for both
    # directions: win[b, line, tap]
    win = plane[rows_c, cols_c]

    def P(k):                              # [B, 4]
        return win[:, :, 7 - k]

    def Q(k):
        return win[:, :, 8 + k]

    pa = jnp.stack([P(k) for k in range(8)], axis=1)   # [B, 8, 4]
    qa = jnp.stack([Q(k) for k in range(8)], axis=1)

    def at(a, line):                       # [B] scalars from line 0/3
        return a[:, line]

    dp_l = jnp.abs(P(2) - 2 * P(1) + P(0))             # [B, 4]
    dq_l = jnp.abs(Q(2) - 2 * Q(1) + Q(0))
    dp0, dp3 = dp_l[:, 0], dp_l[:, 3]
    dq0, dq3 = dq_l[:, 0], dq_l[:, 3]
    d0 = dp0 + dq0
    d3 = dp3 + dq3
    tc25 = (tc * 5 + 1) >> 1
    large_p = (mlp > 3) & (hce == 0)
    large_q = mlq > 3
    beta_3 = beta >> 3
    beta_2 = beta >> 2

    # ---- long-filter decision (large branch) ----
    dpx_l = jnp.abs(P(5) - 2 * P(4) + P(3))
    dqx_l = jnp.abs(Q(5) - 2 * Q(4) + Q(3))
    dp0l = jnp.where(large_p, (dp0 + dpx_l[:, 0] + 1) >> 1, dp0)
    dq0l = jnp.where(large_q, (dq0 + dqx_l[:, 0] + 1) >> 1, dq0)
    dp3l = jnp.where(large_p, (dp3 + dpx_l[:, 3] + 1) >> 1, dp3)
    dq3l = jnp.where(large_q, (dq3 + dqx_l[:, 3] + 1) >> 1, dq3)
    d0l = dp0l + dq0l
    d3l = dp3l + dq3l
    beta53 = (beta * 3) >> 5
    beta_4 = beta >> 4
    ml_p = jnp.where(large_p, mlp, 3)
    ml_q = jnp.where(large_q, mlq, 3)
    p7term = jnp.abs(P(7) - P(6) - P(5) + P(4))
    q7term = jnp.abs(Q(4) - Q(5) - Q(6) + Q(7))
    sp_l = jnp.abs(P(3) - P(0)) + jnp.where((ml_p == 7)[:, None], p7term, 0)
    sq_l = jnp.abs(Q(0) - Q(3)) + jnp.where((ml_q == 7)[:, None], q7term, 0)
    p_mlp = jnp.take_along_axis(pa, ml_p[:, None, None].astype(jnp.int32),
                                axis=1)[:, 0]          # [B, 4] = P(ml_p)
    q_mlq = jnp.take_along_axis(qa, ml_q[:, None, None].astype(jnp.int32),
                                axis=1)[:, 0]
    sp = jnp.where(large_p[:, None],
                   (sp_l + jnp.abs(P(3) - p_mlp) + 1) >> 1, sp_l)
    sq = jnp.where(large_q[:, None],
                   (sq_l + jnp.abs(Q(3) - q_mlq) + 1) >> 1, sq_l)
    abs_pq = jnp.abs(P(0) - Q(0))
    use_large = ((large_p | large_q) & (d0l + d3l < beta) &
                 (sp[:, 0] + sq[:, 0] < beta53) & (abs_pq[:, 0] < tc25) &
                 (sp[:, 3] + sq[:, 3] < beta53) & (abs_pq[:, 3] < tc25) &
                 ((d0l << 1) < beta_4) & ((d3l << 1) < beta_4))

    # ---- strong / weak decisions ----
    pass_d = (d0 + d3 < beta) & ~use_large
    strong = (pass_d & (mlp > 2) & (mlq > 2) &
              (jnp.abs(P(3) - P(0))[:, 0] + jnp.abs(Q(3) - Q(0))[:, 0]
               < beta_3) & (abs_pq[:, 0] < tc25) &
              (jnp.abs(P(3) - P(0))[:, 3] + jnp.abs(Q(3) - Q(0))[:, 3]
               < beta_3) & (abs_pq[:, 3] < tc25) &
              ((d0 << 1) < beta_2) & ((d3 << 1) < beta_2))
    weak = pass_d & ~strong
    side_thr = (beta + (beta >> 1)) >> 3
    nd2 = (mlp > 1) & (mlq > 1)
    nd_p2 = nd2 & (dp0 + dp3 < side_thr)
    nd_q2 = nd2 & (dq0 + dq3 < side_thr)

    # ---- LARGE filter ----
    p, q = pa, qa                        # [B, 8, 4]
    m55 = (p[:, 4] + p[:, 3] + 2 * (p[:, 2] + p[:, 1] + p[:, 0] +
           q[:, 0] + q[:, 1] + q[:, 2]) + q[:, 3] + q[:, 4] + 8) >> 4
    m77 = (p[:, 6] + p[:, 5] + p[:, 4] + p[:, 3] + p[:, 2] + p[:, 1] +
           2 * (p[:, 0] + q[:, 0]) + q[:, 1] + q[:, 2] + q[:, 3] +
           q[:, 4] + q[:, 5] + q[:, 6] + 8) >> 4
    m12 = (p[:, 5] + p[:, 4] + p[:, 3] + p[:, 2] +
           2 * (p[:, 1] + p[:, 0] + q[:, 0] + q[:, 1]) + q[:, 2] +
           q[:, 3] + q[:, 4] + q[:, 5] + 8) >> 4
    m8 = (p[:, 3] + p[:, 2] + p[:, 1] + p[:, 0] + q[:, 0] + q[:, 1] +
          q[:, 2] + q[:, 3] + 4) >> 3
    m37 = (2 * (p[:, 2] + p[:, 1] + p[:, 0] + q[:, 0]) + p[:, 0] +
           p[:, 1] + q[:, 1] + q[:, 2] + q[:, 3] + q[:, 4] + q[:, 5] +
           q[:, 6] + 8) >> 4
    m73 = (p[:, 6] + p[:, 5] + p[:, 4] + p[:, 3] + p[:, 2] + p[:, 1] +
           2 * (q[:, 2] + q[:, 1] + q[:, 0] + p[:, 0]) + q[:, 0] +
           q[:, 1] + 8) >> 4
    mlp_e = ml_p[:, None]
    mlq_e = ml_q[:, None]
    m = jnp.where((mlp_e == 5) & (mlq_e == 5), m55,
        jnp.where(mlp_e == mlq_e, m77,
        jnp.where(mlp_e + mlq_e == 12, m12,
        jnp.where(mlp_e + mlq_e == 8, m8,
        jnp.where(mlq_e == 7, m37, m73)))))
    p_ml1 = jnp.take_along_axis(
        pa, (ml_p - 1)[:, None, None].astype(jnp.int32), axis=1)[:, 0]
    q_ml1 = jnp.take_along_axis(
        qa, (ml_q - 1)[:, None, None].astype(jnp.int32), axis=1)[:, 0]
    refp = (p_mlp + p_ml1 + 1) >> 1
    refq = (q_mlq + q_ml1 + 1) >> 1
    coef = jnp.asarray(_COEF)
    tcw = jnp.asarray(_TCW)
    idx_p = ((ml_p - 3) >> 1).astype(jnp.int32)
    idx_q = ((ml_q - 3) >> 1).astype(jnp.int32)
    ks = jnp.arange(7)
    cp = coef[idx_p][:, :, None]                       # [B, 7, 1]
    cq = coef[idx_q][:, :, None]
    limp = ((tc[:, None] * tcw[idx_p]) >> 1)[:, :, None]
    limq = ((tc[:, None] * tcw[idx_q]) >> 1)[:, :, None]
    pk = pa[:, :7]                                     # [B, 7, 4]
    qk = qa[:, :7]
    dl_p = jnp.clip(((m[:, None, :] * cp + refp[:, None, :] * (64 - cp)
                      + 32) >> 6) - pk, -limp, limp)
    dl_q = jnp.clip(((m[:, None, :] * cq + refq[:, None, :] * (64 - cq)
                      + 32) >> 6) - qk, -limq, limq)
    kmask_p = (ks[None, :] < ml_p[:, None])[:, :, None]
    kmask_q = (ks[None, :] < ml_q[:, None])[:, :, None]
    dl_p = jnp.where(kmask_p, dl_p, 0)
    dl_q = jnp.where(kmask_q, dl_q, 0)

    # ---- STRONG filter ----
    tc_l = tc[:, None]
    tc2, tc3 = tc_l << 1, tc_l * 3
    p3, p2, p1, p0 = p[:, 3], p[:, 2], p[:, 1], p[:, 0]
    q0, q1, q2, q3 = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    ds_p0 = jnp.clip(((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3) - p0,
                     -tc3, tc3)
    ds_p1 = jnp.clip(((p2 + p1 + p0 + q0 + 2) >> 2) - p1, -tc2, tc2)
    ds_p2 = jnp.clip(((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3) - p2,
                     -tc_l, tc_l)
    ds_q0 = jnp.clip(((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3) - q0,
                     -tc3, tc3)
    ds_q1 = jnp.clip(((p0 + q0 + q1 + q2 + 2) >> 2) - q1, -tc2, tc2)
    ds_q2 = jnp.clip(((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3) - q2,
                     -tc_l, tc_l)

    # ---- WEAK filter ----
    delta0 = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    w_apply = jnp.abs(delta0) < 10 * tc_l              # per line
    dw = jnp.clip(delta0, -tc_l, tc_l)
    tc_2 = tc_l >> 1
    dw_p0 = jnp.where(w_apply,
                      jnp.clip(p0 + dw, 0, pix_max) - p0, 0)
    dw_q0 = jnp.where(w_apply,
                      jnp.clip(q0 - dw, 0, pix_max) - q0, 0)
    dwp1 = jnp.clip((((p2 + p0 + 1) >> 1) - p1 + dw) >> 1, -tc_2, tc_2)
    dwq1 = jnp.clip((((q2 + q0 + 1) >> 1) - q1 - dw) >> 1, -tc_2, tc_2)
    dw_p1 = jnp.where(w_apply & nd_p2[:, None],
                      jnp.clip(p1 + dwp1, 0, pix_max) - p1, 0)
    dw_q1 = jnp.where(w_apply & nd_q2[:, None],
                      jnp.clip(q1 + dwq1, 0, pix_max) - q1, 0)

    # ---- select per segment, build tap deltas [B, 14, 4] ----
    ul = use_large[:, None, None]
    st = strong[:, None, None]
    wk = weak[:, None, None]
    zero = jnp.zeros_like(dl_p)
    strong_p = jnp.concatenate(
        [jnp.stack([ds_p0, ds_p1, ds_p2], axis=1), zero[:, 3:]], axis=1)
    strong_q = jnp.concatenate(
        [jnp.stack([ds_q0, ds_q1, ds_q2], axis=1), zero[:, 3:]], axis=1)
    weak_p = jnp.concatenate(
        [jnp.stack([dw_p0, dw_p1], axis=1), zero[:, 2:]], axis=1)
    weak_q = jnp.concatenate(
        [jnp.stack([dw_q0, dw_q1], axis=1), zero[:, 2:]], axis=1)
    dp = jnp.where(ul, dl_p, jnp.where(st, strong_p,
                   jnp.where(wk, weak_p, 0)))
    dq = jnp.where(ul, dl_q, jnp.where(st, strong_q,
                   jnp.where(wk, weak_q, 0)))
    # delta[t] for taps p6..q6: t 0..6 = P(6-t), t 7..13 = Q(t-7)
    delta = jnp.concatenate([jnp.flip(dp, axis=1), dq],
                            axis=1)                     # [B, 14, 4]

    # ---- scatter-add ----
    wtap = jnp.arange(14)
    if vertical:
        srows = py[:, None, None] + lines[None, None, :]          # [B,1,4]
        scols = px[:, None, None] - 7 + wtap[None, :, None]       # [B,14,1]
        srows = jnp.broadcast_to(srows, delta.shape)
        scols = jnp.broadcast_to(scols, delta.shape)
    else:
        srows = py[:, None, None] - 7 + wtap[None, :, None]
        scols = px[:, None, None] + lines[None, None, :]
        srows = jnp.broadcast_to(srows, delta.shape)
        scols = jnp.broadcast_to(scols, delta.shape)
    srows = srows - row0
    if own_h is not None:
        # mask deltas outside the owned row range (halo rows and other
        # shards' segments write nothing here; they own those rows)
        halo = (H - own_h) // 2
        delta = jnp.where((srows >= halo) & (srows < halo + own_h),
                          delta, 0)
    srows = jnp.clip(srows, 0, H - 1)
    scols = jnp.clip(scols, 0, W - 1)
    return plane.at[srows, scols].add(delta)


# ---- chroma pass ------------------------------------------------------------

def _chroma_math(plane, px, py, tc, beta, mlp, mlq, size, vertical: bool,
                 pix_max: int, row0=0, own_h=None):
    """One whole-frame chroma deblock direction.  Mirrors
    Deblocker._filter_chroma (+_chroma_strong/_one_side/_weak).
    row0/own_h: slab-local mode, see _luma_math."""
    H, W = plane.shape
    lines = jnp.arange(4)                  # padded; mask lines >= size
    taps = jnp.arange(8)                   # P(3..0), Q(0..3)
    if vertical:
        rows = py[:, None, None] + lines[None, :, None]
        cols = px[:, None, None] - 4 + taps[None, None, :]
    else:
        rows = py[:, None, None] - 4 + taps[None, None, :]
        cols = px[:, None, None] + lines[None, :, None]
    rows = rows - row0
    win = plane[jnp.clip(rows, 0, H - 1), jnp.clip(cols, 0, W - 1)]

    ml1 = (mlp == 1)[:, None]

    def P(k):                              # raw taps: P(k) = win[..., 3-k]
        return win[:, :, 3 - k]

    def Q(k):
        return win[:, :, 4 + k]

    p0r, p1r, p2raw, p3raw = P(0), P(1), P(2), P(3)
    q0r, q1r, q2r, q3r = Q(0), Q(1), Q(2), Q(3)
    # the decision block substitutes P(2)/P(3) -> P(1) when max_len_p == 1
    # (deblock.py:908-921); the filters read the raw taps
    p2r = jnp.where(ml1, p1r, p2raw)
    p3r = jnp.where(ml1, p1r, p3raw)

    nline = jnp.where(size == 2, 1, 3)     # decision line index
    line0 = jnp.zeros_like(nline)

    def at(a, line):                       # [B] value at per-segment line
        return jnp.take_along_axis(a, line[:, None].astype(jnp.int32),
                                   axis=1)[:, 0]

    beta_3 = beta >> 3
    beta_2 = beta >> 2
    tc25 = (tc * 5 + 1) >> 1
    dp0 = jnp.abs(at(p2r, line0) - 2 * at(p1r, line0) + at(p0r, line0))
    dq0 = jnp.abs(at(q2r, line0) - 2 * at(q1r, line0) + at(q0r, line0))
    dp1 = jnp.abs(at(p2r, nline) - 2 * at(p1r, nline) + at(p0r, nline))
    dq1 = jnp.abs(at(q2r, nline) - 2 * at(q1r, nline) + at(q0r, nline))
    d0 = dp0 + dq0
    d1 = dp1 + dq1
    dsam0 = (((d0 << 1) < beta_2) &
             (jnp.abs(at(p3r, line0) - at(p0r, line0)) +
              jnp.abs(at(q0r, line0) - at(q3r, line0)) < beta_3) &
             (jnp.abs(at(p0r, line0) - at(q0r, line0)) < tc25))
    dsam1 = (((d1 << 1) < beta_2) &
             (jnp.abs(at(p3r, nline) - at(p0r, nline)) +
              jnp.abs(at(q0r, nline) - at(q3r, nline)) < beta_3) &
             (jnp.abs(at(p0r, nline) - at(q0r, nline)) < tc25))
    keep_3 = (mlq == 3) & (d0 + d1 < beta) & dsam0 & dsam1
    mlq_e = jnp.where((mlq == 3) & ~keep_3, 1, mlq)
    mlp_e = jnp.where((mlq == 3) & ~keep_3, 1, mlp)

    strong = (mlp_e == 3) & (mlq_e == 3)
    one_side = (mlq_e == 3) & ~strong
    tc_l = tc[:, None]

    # strong (both sides)
    s_p0 = jnp.clip((p3r + p2r + p1r + 2 * p0r + q0r + q1r + q2r + 4) >> 3,
                    p0r - tc_l, p0r + tc_l) - p0r
    s_p1 = jnp.clip((2 * p3r + p2r + 2 * p1r + p0r + q0r + q1r + 4) >> 3,
                    p1r - tc_l, p1r + tc_l) - p1r
    s_p2 = jnp.clip((3 * p3r + 2 * p2r + p1r + p0r + q0r + 4) >> 3,
                    p2r - tc_l, p2r + tc_l) - p2r
    s_q0 = jnp.clip((p2r + p1r + p0r + 2 * q0r + q1r + q2r + q3r + 4) >> 3,
                    q0r - tc_l, q0r + tc_l) - q0r
    s_q1 = jnp.clip((p1r + p0r + q0r + 2 * q1r + q2r + 2 * q3r + 4) >> 3,
                    q1r - tc_l, q1r + tc_l) - q1r
    s_q2 = jnp.clip((p0r + q0r + q1r + 2 * q2r + 3 * q3r + 4) >> 3,
                    q2r - tc_l, q2r + tc_l) - q2r

    # one-side strong (P taps unsubstituted: only p1/p0 used)
    o_p0 = jnp.clip((3 * p1r + 2 * p0r + q0r + q1r + q2r + 4) >> 3,
                    p0r - tc_l, p0r + tc_l) - p0r
    o_q0 = jnp.clip((2 * p1r + p0r + 2 * q0r + q1r + q2r + q3r + 4) >> 3,
                    q0r - tc_l, q0r + tc_l) - q0r
    o_q1 = jnp.clip((p1r + p0r + q0r + 2 * q1r + q2r + 2 * q3r + 4) >> 3,
                    q1r - tc_l, q1r + tc_l) - q1r
    o_q2 = jnp.clip((p0r + q0r + q1r + 2 * q2r + 3 * q3r + 4) >> 3,
                    q2r - tc_l, q2r + tc_l) - q2r

    # weak
    dlt = jnp.clip((((q0r - p0r) * 4) + p1r - q1r + 4) >> 3, -tc_l, tc_l)
    w_p0 = jnp.clip(p0r + dlt, 0, pix_max) - p0r
    w_q0 = jnp.clip(q0r - dlt, 0, pix_max) - q0r

    st = strong[:, None]
    os_ = one_side[:, None]
    d_p0 = jnp.where(st, s_p0, jnp.where(os_, o_p0, w_p0))
    d_p1 = jnp.where(st, s_p1, 0)
    d_p2 = jnp.where(st, s_p2, 0)
    d_q0 = jnp.where(st, s_q0, jnp.where(os_, o_q0, w_q0))
    d_q1 = jnp.where(st, s_q1, jnp.where(os_, o_q1, 0))
    d_q2 = jnp.where(st, s_q2, jnp.where(os_, o_q2, 0))

    lmask = lines[None, :] < size[:, None]
    delta = jnp.stack([jnp.zeros_like(d_p0), d_p2, d_p1, d_p0,
                       d_q0, d_q1, d_q2, jnp.zeros_like(d_p0)],
                      axis=1)              # [B, 8, 4] taps p3..q3
    delta = jnp.where(lmask[:, None, :], delta, 0)

    wtap = jnp.arange(8)
    if vertical:
        srows = jnp.broadcast_to(py[:, None, None] + lines[None, None, :],
                                 delta.shape)
        scols = jnp.broadcast_to(px[:, None, None] - 4 +
                                 wtap[None, :, None], delta.shape)
    else:
        srows = jnp.broadcast_to(py[:, None, None] - 4 +
                                 wtap[None, :, None], delta.shape)
        scols = jnp.broadcast_to(px[:, None, None] + lines[None, None, :],
                                 delta.shape)
    srows = srows - row0
    if own_h is not None:
        halo = (H - own_h) // 2
        delta = jnp.where((srows >= halo) & (srows < halo + own_h),
                          delta, 0)
    srows = jnp.clip(srows, 0, H - 1)
    scols = jnp.clip(scols, 0, W - 1)
    return plane.at[srows, scols].add(delta)


@functools.partial(jax.jit, static_argnames=("vertical", "pix_max"))
def _luma_jit(plane, px, py, tc, beta, mlp, mlq, hce, vertical, pix_max):
    return _luma_math(plane, px, py, tc, beta, mlp, mlq, hce, vertical,
                      pix_max)


@functools.partial(jax.jit, static_argnames=("vertical", "pix_max"))
def _chroma_jit(plane, px, py, tc, beta, mlp, mlq, size, vertical, pix_max):
    return _chroma_math(plane, px, py, tc, beta, mlp, mlq, size, vertical,
                        pix_max)


def _seg_arrays(segs, n_fields):
    """Transpose segment tuples into padded [B] arrays.  Padded segments
    keep tc == 0 and mlp == mlq == 0, which masks every filter branch off
    (zero deltas), so padding is an exact no-op."""
    B = _pad_pow2(max(len(segs), 1))
    a = np.zeros((n_fields, B), np.int32)
    if segs:
        a[:, :len(segs)] = np.asarray(segs, np.int32).T
    return [jnp.asarray(row) for row in a]


def rasterize_deblock(sps, pps, tabs, fb, slice_rpls, vertical):
    """Host pass: per-segment deblock parameters for one direction
    (pixel-independent — BS/tc/beta/max-len come from the tab planes).
    Returns the populated _Rasterizer."""
    ras = _Rasterizer(sps, pps, tabs, fb)
    ras.slice_rpls = slice_rpls
    for ry in range(pps.ctb_height):
        for rx in range(pps.ctb_width):
            ras.deblock_ctb(rx, ry, vertical)
    return ras


def deblock_frame_device(sps, pps, tabs, fb, slice_rpls):
    """Whole-frame device deblock (both directions, all planes), in place.
    Returns False when the stream needs the host path (LADF)."""
    if getattr(sps, "num_ladf_intervals", 0):
        return False
    pix_max = (1 << sps.bit_depth) - 1
    for vertical in (True, False):
        ras = rasterize_deblock(sps, pps, tabs, fb, slice_rpls, vertical)
        if ras.luma_segs:
            px, py, tc, beta, mlp, mlq, hce = _seg_arrays(ras.luma_segs, 7)
            out = _luma_jit(jnp.asarray(fb.planes[0]), px, py, tc, beta,
                            mlp, mlq, hce, vertical, pix_max)
            fb.planes[0][:] = np.asarray(out)
        for c in (1, 2):
            segs = ras.chroma_segs.get(c) or []
            if not segs:
                continue
            px, py, tc, beta, mlp, mlq, size = _seg_arrays(segs, 7)
            out = _chroma_jit(jnp.asarray(fb.planes[c]), px, py, tc, beta,
                              mlp, mlq, size, vertical, pix_max)
            fb.planes[c][:] = np.asarray(out)
    return True
