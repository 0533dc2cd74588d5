"""Fused device-resident pixel pipeline: one jitted chain per frame.

Device-resident replacement for the per-stage device filters: instead of
round-tripping pixels through host NumPy between LMCS / deblock / SAO /
ALF (the round-4 `device_pipeline` ran the mesh queue on one device with
an np.asarray materialization between every pass), the WHOLE post-recon
chain

    [residual-add] -> LMCS-inverse -> deblock-V -> deblock-H
                   -> SAO -> ALF -> CC-ALF

is traced as ONE jit-compiled function: planes upload once, every
intermediate stays device-resident (XLA fuses the elementwise stages),
and only the final planes download.  This is the residency architecture
of the reference's in-place frame pipeline (vvc_thread.c:41-51 runs all
8 stages over one pixel buffer) expressed in the XLA execution model.

Everything per-pixel is DERIVED ON DEVICE from per-CTB/per-segment
parameters (a few KB per frame), so host<->device traffic per frame is
one plane-set up (+ a residual set for deferred inter recon) and one
plane-set down — measured and accumulated in `stats`.

Stage formulations:
  * LMCS inverse: 1D LUT gather gated by a per-CTB mask
    (ff_vvc_lmcs_filter, vvc_filter.c:1322).
  * Deblock: the segment-batched math of ops/deblock_device.py
    (_luma_math/_chroma_math), parameters host-rasterized (pixel-free).
  * SAO: ops/sao_device._sao_math on per-pixel maps expanded from
    per-CTB params with jnp.repeat; the unfilterable-edge `keep` map is
    computed from per-CTB border descriptors (frame borders only — the
    across-slice/tile-disabled cases fall back to the host path).
  * ALF: classification ON DEVICE — the whole-frame vectorized form of
    the reference's per-CTU gradient classifier
    (vvc_filter_template.c:295-382): 2x2-grid laplacian gradients with
    virtual-boundary row substitution via host-precomputed row-index
    arrays, 4x4-block sums, and the exact integer direction/activity
    decisions (the single >32-bit product comparison is done with an
    exact split-compare).  Filtering accumulates the 12 clipped-diamond
    taps slot by slot (vvc_filter_template.c:43), chroma uses the 6-tap
    subset, CC-ALF the 7-tap luma-sampled pass.

Bit-exactness is pinned against the host golden by
tests/test_device_filters.py (fused chain) and the decoder-integrated
test_device_pipeline_single_chip.
"""
from __future__ import annotations

import functools
import time

import numpy as np
import jax
import jax.numpy as jnp

from ..alf import (VVCALF, ALF_BORDER_LUMA, ALF_BORDER_CHROMA,
                   ALF_VB_POS_ABOVE_LUMA, ALF_VB_POS_ABOVE_CHROMA,
                   ALF_NUM_FILTERS_LUMA, _TRANSPOSE_IDX, _ARG_VAR)
from ..sao import SaoFilter, SAO_BAND, SAO_EDGE, _EDGE_IDX
from .alf_device import _LUMA_TAPS, _CHROMA_SLOT, _vb_row_offsets
from .deblock_device import (rasterize_deblock, _pad_pow2, _luma_math,
                             _chroma_math)
from .sao_device import _sao_math
from . import data as D

# transfer accounting (bytes) and wall time of fused_frame_filters calls
# that ran the chain (host prep + transfers + device); reset_stats() clears
stats = {"up_bytes": 0, "down_bytes": 0, "frames": 0, "seconds": 0.0}


def reset_stats():
    stats.update(up_bytes=0, down_bytes=0, frames=0, seconds=0.0)


def _up(a):
    """Upload a host array, counting bytes."""
    a = np.ascontiguousarray(a)
    stats["up_bytes"] += a.nbytes
    return jnp.asarray(a)


# ---------------------------------------------------------------------------
# device math
# ---------------------------------------------------------------------------

def _expand_ctb(a, cs_v, cs_h, H, W):
    """Per-CTB [ch, cw] -> per-pixel [H, W] (repeat + crop)."""
    return jnp.repeat(jnp.repeat(a, cs_v, axis=0), cs_h, axis=1)[:H, :W]


def _lmcs_apply(y, lut, mask, cs, H, W):
    m = _expand_ctb(mask, cs, cs, H, W)
    return jnp.where(m != 0, lut[y], y)


def _sao_apply(plane, p, cs_v, cs_h, shift, pix_max):
    """p: dict of per-CTB param arrays (typ, m1, offs[5], kl, kr, kt, kb,
    ax, bx)."""
    H, W = plane.shape
    typ = _expand_ctb(p["typ"], cs_v, cs_h, H, W)
    m1 = _expand_ctb(p["m1"], cs_v, cs_h, H, W)
    offs = jnp.stack([_expand_ctb(p["offs"][k], cs_v, cs_h, H, W)
                      for k in range(5)])
    xs = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    ys = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    x_loc = xs & (cs_h - 1)
    kl = _expand_ctb(p["kl"], cs_v, cs_h, H, W)
    kr = _expand_ctb(p["kr"], cs_v, cs_h, H, W)
    kt = _expand_ctb(p["kt"], cs_v, cs_h, H, W)
    kb = _expand_ctb(p["kb"], cs_v, cs_h, H, W)
    ax = _expand_ctb(p["ax"], cs_v, cs_h, H, W)
    bx = _expand_ctb(p["bx"], cs_v, cs_h, H, W)
    in_x = (x_loc >= ax) & (x_loc < bx)
    keep = ((xs == 0) & (kl != 0)) | ((xs == W - 1) & (kr != 0)) | \
        ((ys == 0) & (kt != 0) & in_x) | \
        ((ys == H - 1) & (kb != 0) & in_x)
    pad = jnp.pad(plane, 1, mode="edge")
    return _sao_math(pad, typ, m1, offs, keep.astype(jnp.int32),
                     shift, pix_max)


def _cmp_prod_le(a, b, c, d):
    """Exact a*b <= c*d for 0 <= operands < 2^19 without 64-bit ints:
    split b/d at 10 bits and compare canonical (hi, lo) pairs."""
    ah = a * (b >> 10)
    al = a * (b & 1023)
    ch = c * (d >> 10)
    cl = c * (d & 1023)
    a1 = ah + (al >> 10)
    a0 = al & 1023
    c1 = ch + (cl >> 10)
    c0 = cl & 1023
    return (a1 < c1) | ((a1 == c1) & (a0 <= c0))


def _alf_classify(P3, r0sel, r3sel, blk_start1, blk_end3, blk_ac,
                  nby, nbx, bd):
    """Whole-frame ALF luma classification.  P3: [H+6, W+6] padded plane;
    r0sel/r3sel: [GH] P3-row indices (VB-substituted); blk_*: [nby]
    per-block-row sum window / activity multiplier.  Returns per-4x4
    (class_idx, transpose_idx) [nby, nbx] int32."""
    GH = r0sel.shape[0]
    GW = nbx * 2 + 2
    # row planes of the 2x2 gradient grid (rows I, I+1, I+2, I+3 with
    # substituted I/I+3), cols J..J+3 via slicing
    rI = jnp.take(P3, r0sel, axis=0)          # [GH, W+6]
    r1 = P3[1::2][:GH]                         # rows I+1 (I even)
    r2 = P3[2::2][:GH]
    r3 = jnp.take(P3, r3sel, axis=0)

    def cols(r, j):                            # [GH, GW] cols J+j, J=2gx
        return r[:, j:j + 2 * GW:2][:, :GW]
    v0 = cols(r1, 1) << 1
    v1 = cols(r2, 2) << 1
    g0 = jnp.abs(v0 - cols(rI, 1) - cols(r2, 1)) + \
        jnp.abs(v1 - cols(r1, 2) - cols(r3, 2))
    g1 = jnp.abs(v0 - cols(r1, 0) - cols(r1, 2)) + \
        jnp.abs(v1 - cols(r2, 1) - cols(r2, 3))
    g2 = jnp.abs(v0 - cols(rI, 0) - cols(r2, 2)) + \
        jnp.abs(v1 - cols(r1, 1) - cols(r3, 3))
    g3 = jnp.abs(v0 - cols(rI, 2) - cols(r2, 0)) + \
        jnp.abs(v1 - cols(r1, 3) - cols(r3, 1))

    def blksum(g):
        # columns: window of 4 starting at 2bx
        c = g[:, 0:2 * nbx:2] + g[:, 1:2 * nbx + 1:2] + \
            g[:, 2:2 * nbx + 2:2] + g[:, 3:2 * nbx + 3:2]   # [GH, nbx]
        # rows: 2by + j for j in [start, end)
        j0 = c[0:2 * nby:2]
        j1 = c[1:2 * nby + 1:2]
        j2 = c[2:2 * nby + 2:2]
        j3 = c[3:2 * nby + 3:2]
        s = j0 + j1 + j2 + j3
        s = s - jnp.where(blk_start1[:, None] != 0, j0, 0)
        s = s - jnp.where(blk_end3[:, None] != 0, j3, 0)
        return s                                             # [nby, nbx]
    sv = blksum(g0)
    sh_ = blksum(g1)
    d0 = blksum(g2)
    d1 = blksum(g3)

    dir_hv = (sv <= sh_).astype(jnp.int32)
    hv1 = jnp.maximum(sv, sh_)
    hv0 = jnp.minimum(sv, sh_)
    dir_d = (d0 <= d1).astype(jnp.int32)
    dd1 = jnp.maximum(d0, d1)
    dd0 = jnp.minimum(d0, d1)
    dir1 = _cmp_prod_le(dd1, hv0, hv1, dd0).astype(jnp.int32)
    hvd1 = jnp.where(dir1 != 0, hv1, dd1)
    hvd0 = jnp.where(dir1 != 0, hv0, dd0)
    sum_hv = sh_ + sv
    arg_var = jnp.asarray(np.asarray(_ARG_VAR, np.int32))
    ci = arg_var[jnp.clip((sum_hv * blk_ac[:, None]) >> (bd - 1), 0, 15)]
    ci = ci + jnp.where(hvd1 * 2 > 9 * hvd0, ((dir1 << 1) + 2) * 5,
                        jnp.where(hvd1 > 2 * hvd0,
                                  ((dir1 << 1) + 1) * 5, 0))
    ti = dir_d * 2 + dir_hv
    return ci, ti


def _alf_filter_plane(cur, P3, rowsel, vbsel, cf_px, cl_px, taps, slots,
                      border, pix_max):
    """Clipped-diamond filter: cur [H, W]; P3 padded source [H+2b, W+2b];
    rowsel [7, H] P3-row indices; cf_px/cl_px per-pixel [12(HW-slot
    subset), H, W] handled by the caller as a dict slot->[H, W]."""
    H, W = cur.shape
    rows = [jnp.take(P3, rowsel[k], axis=0) for k in range(7)]

    def at(k, dx):      # [H, W] samples at row-plane k, col offset dx
        return rows[k][:, border + dx:border + dx + W]
    acc = jnp.zeros_like(cur)
    for slot, (ka, da, kb, db) in zip(slots, taps):
        v0 = at(ka, da)
        v1 = at(kb, db)
        cl = cl_px[slot]
        d = jnp.clip(v0 - cur, -cl, cl) + jnp.clip(v1 - cur, -cl, cl)
        acc = acc + cf_px[slot] * d
    acc = jnp.where(vbsel[:, None] != 0, (acc + (1 << 9)) >> 10,
                    (acc + 64) >> 7)
    return jnp.clip(cur + acc, 0, pix_max)


def _cc_filter(dst, P3l, rowsel, skip, cf_px, hs, half, pix_max):
    """CC-ALF: dst [Hc, Wc] chroma; P3l [H+6, W+6] padded pre-ALF luma;
    rowsel [4, Hc] P3l-row indices r0..r3; skip [Hc] (cf=0 rows);
    cf_px: dict j -> per-pixel coeff [Hc, Wc]."""
    Hc, Wc = dst.shape
    b = ALF_BORDER_LUMA
    r = [jnp.take(P3l, rowsel[j], axis=0) for j in range(4)]

    def at(j, dx):      # luma cols (x << hs) + dx
        return r[j][:, b + dx:b + dx + ((Wc - 1) << hs) + 1:1 << hs]
    cur = at(1, 0)
    taps = ((0, 0), (1, -1), (1, 1), (2, -1), (2, 0), (2, 1), (3, 0))
    acc = jnp.zeros_like(dst)
    for j, (rk, dx) in enumerate(taps):
        cf = jnp.where(skip[:, None] != 0, 0, cf_px[j])
        acc = acc + cf * (at(rk, dx) - cur)
    acc = jnp.clip((acc + 64) >> 7, -half, half - 1)
    return jnp.clip(dst + acc, 0, pix_max)


# ---------------------------------------------------------------------------
# the fused chain (one jit trace per structural meta)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnums=(0,))
def _chain(meta, a):
    """meta: hashable structural tuple; a: dict of device arrays.
    Returns the filtered planes tuple."""
    m = dict(meta)
    bd = m["bd"]
    pix_max = (1 << bd) - 1
    cs = m["cs"]
    nc = m["nc"]
    # planes ride the wire as uint16 (samples <= 12-bit), residuals as
    # int16 (spec residual range): half the host<->device traffic
    planes = [a[f"p{c}"].astype(jnp.int32) for c in range(nc)]
    # --- residual add (deferred inter recon) ---
    if m["has_res"]:
        for c in range(nc):
            planes[c] = jnp.clip(
                planes[c] + a[f"res{c}"].astype(jnp.int32), 0, pix_max)
    # --- LMCS inverse (luma) ---
    if m["has_lmcs"]:
        H, W = planes[0].shape
        planes[0] = _lmcs_apply(planes[0], a["lmcs_lut"], a["lmcs_mask"],
                                cs, H, W)
    # --- deblock: V then H ---
    for d, vertical in ((0, True), (1, False)):
        for c in range(nc):
            key = f"db{d}c{c}"
            if not m[key]:
                continue
            s = a[key].astype(jnp.int32)   # uploaded int16 (half traffic)
            if c == 0:
                planes[0] = _luma_math(planes[0], s[0], s[1], s[2], s[3],
                                       s[4], s[5], s[6], vertical, pix_max)
            else:
                planes[c] = _chroma_math(planes[c], s[0], s[1], s[2], s[3],
                                         s[4], s[5], s[6], vertical,
                                         pix_max)
    # --- SAO ---
    shift = bd - 5
    for c in range(nc):
        if not m[f"sao{c}"]:
            continue
        hs = m["hs"] if c else 0
        vs = m["vs"] if c else 0
        planes[c] = _sao_apply(
            planes[c],
            {k: a[f"sao{c}_{k}"] for k in
             ("typ", "m1", "offs", "kl", "kr", "kt", "kb", "ax", "bx")},
            cs >> vs, cs >> hs, shift, pix_max)
    post_sao = list(planes)
    # --- ALF luma ---
    T = jnp.asarray(np.asarray(_TRANSPOSE_IDX, np.int32))
    if m["alf0"]:
        y = post_sao[0]
        H, W = y.shape
        nby, nbx = H // 4, W // 4
        P3 = jnp.pad(y, ALF_BORDER_LUMA, mode="edge")
        ci, ti = _alf_classify(P3, a["cls_r0"], a["cls_r3"],
                               a["blk_start1"], a["blk_end3"], a["blk_ac"],
                               nby, nbx, bd)
        setidx = a["alf0_set"]                       # [nby, nbx]
        cfb = a["alf0_cf"][setidx, ci]               # [nby, nbx, 12]
        clb = a["alf0_cl"][setidx, ci]
        perm = T[ti]                                 # [nby, nbx, 12]
        cfb = jnp.take_along_axis(cfb, perm, axis=2)
        clb = jnp.take_along_axis(clb, perm, axis=2)

        def px(bk):                                  # [nby,nbx] -> [H,W]
            return jnp.repeat(jnp.repeat(bk, 4, 0), 4, 1)
        cf_px = {s: px(cfb[:, :, s]) for s in range(12)}
        cl_px = {s: px(clb[:, :, s]) for s in range(12)}
        planes[0] = _alf_filter_plane(y, P3, a["alf0_row"], a["alf0_vb"],
                                      cf_px, cl_px, _LUMA_TAPS, range(12),
                                      ALF_BORDER_LUMA, pix_max)
    # --- ALF chroma + CC-ALF ---
    half = 1 << (bd - 1)
    for c in (1, 2):
        if nc == 1:
            break
        out = planes[c]
        if m[f"alf{c}"]:
            src = post_sao[c]
            Hc, Wc = src.shape
            csv = cs >> m["vs"]
            csh = cs >> m["hs"]
            P3c = jnp.pad(src, ALF_BORDER_CHROMA, mode="edge")
            cfb = a[f"alf{c}_cf"][a[f"alf{c}_set"]]  # [ch, cw, 12]
            clb = a[f"alf{c}_cl"][a[f"alf{c}_set"]]
            cf_px = {s: _expand_ctb(cfb[:, :, s], csv, csh, Hc, Wc)
                     for s in _CHROMA_SLOT}
            cl_px = {s: _expand_ctb(clb[:, :, s], csv, csh, Hc, Wc)
                     for s in _CHROMA_SLOT}
            taps = tuple(_LUMA_TAPS[s] for s in _CHROMA_SLOT)
            out = _alf_filter_plane(src, P3c, a[f"alfc_row"],
                                    a["alfc_vb"], cf_px, cl_px, taps,
                                    _CHROMA_SLOT, ALF_BORDER_CHROMA,
                                    pix_max)
        if m[f"cc{c}"]:
            Hc, Wc = out.shape
            csv = cs >> m["vs"]
            csh = cs >> m["hs"]
            P3l = jnp.pad(post_sao[0], ALF_BORDER_LUMA, mode="edge")
            ccb = a[f"cc{c}_cf"][a[f"cc{c}_set"]]    # [ch, cw, 7]
            cf_px = {j: _expand_ctb(ccb[:, :, j], csv, csh, Hc, Wc)
                     for j in range(7)}
            out = _cc_filter(out, P3l, a["cc_row"], a["cc_skip"], cf_px,
                             m["hs"], half, pix_max)
        planes[c] = out
    return tuple(p.astype(jnp.uint16) for p in planes)


# ---------------------------------------------------------------------------
# host-side parameter rasterization
# ---------------------------------------------------------------------------

def _sao_ctb_params(sf, c, sps, pps, tabs):
    """Per-CTB SAO parameter arrays for component c, or None if SAO is
    off on the whole plane.  Requires restore-free streams (the caller
    gates on loop-filter-across flags)."""
    ch, cw = pps.ctb_height, pps.ctb_width
    hs, vs = sps.hshift[c], sps.vshift[c]
    W = pps.width >> hs
    H = pps.height >> vs
    z = lambda: np.zeros((ch, cw), np.int32)
    typ, m1 = z(), z()
    offs = np.zeros((5, ch, cw), np.int32)
    kl, kr, kt, kb, ax = z(), z(), z(), z(), z()
    bx = np.full((ch, cw), 1 << 30, np.int32)
    any_on = False
    for ry in range(ch):
        for rx in range(cw):
            rs = ry * cw + rx
            t = int(tabs.sao_type[rs, c])
            if t == 0:
                continue
            any_on = True
            typ[ry, rx] = t
            off = tabs.sao_offset[rs, c]
            if t == SAO_BAND:
                m1[ry, rx] = int(tabs.sao_band_pos[rs, c])
                for k in range(4):
                    offs[k, ry, rx] = off[k + 1]
                continue
            eo = int(tabs.sao_eo_class[rs, c])
            m1[ry, rx] = eo
            for i in range(5):
                offs[i, ry, rx] = off[_EDGE_IDX[i]]
            edges = [rx == 0, ry == 0, rx == cw - 1, ry == ch - 1]
            x0 = (rx << sps.ctb_log2_size_y) >> hs
            w = min(sps.ctb_size_y >> hs, W - x0)
            init_x, rw = 0, w
            if eo != 1:
                if edges[0]:
                    kl[ry, rx] = 1
                    init_x = 1
                if edges[2]:
                    kr[ry, rx] = 1
                    rw = w - 1
            if eo != 0:
                if edges[1]:
                    kt[ry, rx] = 1
                if edges[3]:
                    kb[ry, rx] = 1
                ax[ry, rx] = init_x
                bx[ry, rx] = rw
    if not any_on:
        return None
    return dict(typ=typ, m1=m1, offs=offs, kl=kl, kr=kr, kt=kt, kb=kb,
                ax=ax, bx=bx)


def _alf_vb_arrays(H, cs_v, border, vb_above, is_luma):
    """Global tap row-index [7, H] + near-vb [H] arrays composed from the
    per-CTB-row _vb_row_offsets."""
    rowsel = np.zeros((7, H), np.int32)
    vbsel = np.zeros(H, np.int32)
    y0 = 0
    while y0 < H:
        h = min(cs_v, H - y0)
        vb = cs_v - vb_above
        o = _vb_row_offsets(h, vb, is_luma)
        ys = np.arange(h)
        rowsel[:, y0:y0 + h] = border + y0 + ys[None, :] + o
        vbsel[y0:y0 + h] = ((ys >= vb - 1) & (ys <= vb)).astype(np.int32)
        y0 += h
    return rowsel, vbsel


def _cls_arrays(H, cs):
    """Classification grid row selectors + block-row windows (luma)."""
    GH = (H + 4) // 2
    gy = np.arange(GH)
    I = 2 * gy
    yloc = I & (cs - 1)
    vb = cs - ALF_VB_POS_ABOVE_LUMA
    r0 = np.where(yloc == vb + 2, I + 1, I).astype(np.int32)
    r3 = np.where(yloc == vb, I + 2, I + 3).astype(np.int32)
    nby = H // 4
    by = np.arange(nby)
    bloc = (4 * by) & (cs - 1)
    start1 = (bloc == vb).astype(np.int32)
    end3 = (bloc + 4 == vb).astype(np.int32)
    ac = np.where((bloc + 4 == vb) | (bloc == vb), 3, 2).astype(np.int32)
    return r0, r3, start1, end3, ac


def _cc_arrays(Hc, cs, vs):
    """CC-ALF luma tap row indices [4, Hc] + skip [Hc]."""
    b = ALF_BORDER_LUMA
    cs_v = cs >> vs
    rowsel = np.zeros((4, Hc), np.int32)
    skip = np.zeros(Hc, np.int32)
    y0 = 0
    while y0 < Hc:
        h = min(cs_v, Hc - y0)
        vb = (cs_v << vs) - ALF_VB_POS_ABOVE_LUMA
        yy = np.arange(h)
        pos = yy << vs
        sk = (vs == 0) & ((pos == vb) | (pos == vb + 1))
        r0 = pos - 1
        r1 = pos.copy()
        r2 = pos + 1
        r3 = pos + 2
        mm = (pos == vb - 2) | (pos == vb + 1)
        r3 = np.where(mm, r2, r3)
        mm = (pos == vb - 1) | (pos == vb)
        r3 = np.where(mm, r1, r3)
        r2 = np.where(mm, r1, r2)
        r0 = np.where(mm, r1, r0)
        base = b + (y0 << vs)
        for j, rr in enumerate((r0, r1, r2, r3)):
            rowsel[j, y0:y0 + h] = base + rr
        skip[y0:y0 + h] = sk.astype(np.int32)
        y0 += h
    return rowsel, skip


def _alf_ctb_params(sps, pps, tabs, sh_list, alf_list):
    """Per-CTB ALF set indices + the set tables.  Returns None when ALF
    is entirely off; raises KeyError on a missing APS (caller falls
    back)."""
    ch, cw = pps.ctb_height, pps.ctb_width
    bd = sps.bit_depth
    t = D.tables()
    clip_set = np.array([1 << bd, 1 << (bd - 3), 1 << (bd - 5),
                         1 << (bd - 7)], np.int64)
    out = {}
    # --- luma: unique (fixed/filt_idx | aps_id) -> percls [25, 12] ---
    luma_sets = {None: (np.zeros((25, 12), np.int64),
                        np.ones((25, 12), np.int64))}   # set 0: identity
    set_idx = np.zeros((ch, cw), np.int32)
    aps_map = t["alf_aps_class_to_filt_map"]
    for ry in range(ch):
        for rx in range(cw):
            rs = ry * cw + rx
            if not tabs.alf_ctb_flag[rs, 0]:
                continue
            if tabs.alf_fixed[rs]:
                key = ("fix", int(tabs.alf_filt_idx[rs]))
                if key not in luma_sets:
                    c2f = t["alf_class_to_filt_map"][key[1]]
                    cf = t["alf_fix_filt_coeff"].astype(np.int64)[c2f]
                    cl = np.full((25, 12), clip_set[0], np.int64)
                    luma_sets[key] = (cf, cl)
            else:
                key = ("aps", int(tabs.alf_aps_id[rs, 0]))
                if key not in luma_sets:
                    aps = alf_list[key[1]]
                    cf = aps.luma_coeff[aps_map]
                    cl = clip_set[aps.luma_clip_idx[aps_map]]
                    luma_sets[key] = (cf, cl)
            set_idx[ry, rx] = list(luma_sets).index(key)
    if len(luma_sets) > 1:
        cf = np.stack([v[0] for v in luma_sets.values()]).astype(np.int32)
        cl = np.stack([v[1] for v in luma_sets.values()]).astype(np.int32)
        # per-4x4-block set index (blocks inherit their CTB's set)
        nby, nbx = pps.height // 4, pps.width // 4
        blky = np.minimum(np.arange(nby) * 4 // sps.ctb_size_y, ch - 1)
        blkx = np.minimum(np.arange(nbx) * 4 // sps.ctb_size_y, cw - 1)
        out["alf0_set"] = set_idx[np.ix_(blky, blkx)]
        out["alf0_cf"] = cf
        out["alf0_cl"] = cl
    # --- chroma: unique (aps_id, alt) -> 12-slot coeff/clip ---
    if sps.chroma_format_idc:
        off = (0, 3, 5, 7)
        for c in (1, 2):
            csets = {None: (np.zeros(12, np.int64), np.ones(12, np.int64))}
            sidx = np.zeros((ch, cw), np.int32)
            any_on = False
            for ry in range(ch):
                for rx in range(cw):
                    rs = ry * cw + rx
                    if not tabs.alf_ctb_flag[rs, c]:
                        continue
                    any_on = True
                    rsh = sh_list[int(tabs.slice_idx[ry, rx])].r
                    aid = rsh.sh_alf_aps_id_chroma
                    alt = int(tabs.alf_alt_idx[rs, c - 1])
                    key = (aid, alt)
                    if key not in csets:
                        aps = alf_list[aid]
                        cf = np.zeros(12, np.int64)
                        cl = np.ones(12, np.int64)
                        for k, slot in enumerate(_CHROMA_SLOT):
                            cf[slot] = aps.chroma_coeff[alt][k]
                            cl[slot] = 1 << (
                                bd - off[int(aps.chroma_clip_idx[alt][k])])
                        csets[key] = (cf, cl)
                    sidx[ry, rx] = list(csets).index(key)
            if any_on:
                out[f"alf{c}_set"] = sidx
                out[f"alf{c}_cf"] = np.stack(
                    [v[0] for v in csets.values()]).astype(np.int32)
                out[f"alf{c}_cl"] = np.stack(
                    [v[1] for v in csets.values()]).astype(np.int32)
        # --- CC-ALF: unique (aps_id, idc) -> 7 coeffs ---
        for c in (1, 2):
            ccsets = {None: np.zeros(7, np.int64)}
            sidx = np.zeros((ch, cw), np.int32)
            any_on = False
            for ry in range(ch):
                for rx in range(cw):
                    rs = ry * cw + rx
                    idc = int(tabs.alf_cc_idc[rs, c - 1])
                    if not idc:
                        continue
                    rsh = sh_list[int(tabs.slice_idx[ry, rx])].r
                    aid = rsh.sh_alf_cc_cb_aps_id if c == 1 else \
                        rsh.sh_alf_cc_cr_aps_id
                    aps = alf_list.get(aid)
                    if aps is None:
                        continue
                    any_on = True
                    key = (aid, idc)
                    if key not in ccsets:
                        ccsets[key] = aps.cc_coeff[c - 1][idc - 1]
                    sidx[ry, rx] = list(ccsets).index(key)
            if any_on:
                out[f"cc{c}_set"] = sidx
                out[f"cc{c}_cf"] = np.stack(
                    list(ccsets.values())).astype(np.int32)
    return out


def eligible(sps, pps, tabs):
    """Structural eligibility for the fused chain (everything else falls
    back to the host stages)."""
    if getattr(sps, "num_ladf_intervals", 0):
        return False        # LADF reads pixel averages mid-deblock
    if not pps.r.pps_loop_filter_across_slices_enabled_flag and \
            tabs.slice_idx.max() > 0:
        return False        # SAO/ALF restore regions at slice edges
    if pps.r.num_tiles_in_pic > 1 and \
            not pps.r.pps_loop_filter_across_tiles_enabled_flag:
        return False
    if pps.width % 8 or pps.height % 8:
        return False        # 4x4 ALF block grid alignment
    return True


def fused_frame_filters(sps, pps, tabs, fb, sh_list, alf_list, lmcs,
                        recon_jobs, slice_rpls, res_planes=None):
    """Run the whole post-recon pixel chain on device for one frame.
    Returns True when the chain ran (planes updated in place); False when
    the frame is ineligible (caller runs the host stages instead)."""
    if not eligible(sps, pps, tabs):
        return False
    t0 = time.monotonic()
    nc = 3 if sps.chroma_format_idc else 1
    meta = {"bd": sps.bit_depth, "cs": sps.ctb_size_y, "nc": nc,
            "hs": sps.hshift[1] if nc == 3 else 0,
            "vs": sps.vshift[1] if nc == 3 else 0}
    arrs = {}
    # --- planes (+ deferred residual); uint16/int16 on the wire ---
    for c in range(nc):
        arrs[f"p{c}"] = _up(np.asarray(fb.planes[c], np.uint16))
    meta["has_res"] = res_planes is not None
    if res_planes is not None:
        # spec residual range is [-2^15, 2^15-1] == int16 — except under
        # sps_extended_precision_flag (range up to +-2^20)
        rdt = np.int32 if sps.r.sps_extended_precision_flag else np.int16
        for c in range(nc):
            arrs[f"res{c}"] = _up(np.asarray(res_planes[c], rdt))
    # --- LMCS ---
    meta["has_lmcs"] = False
    if lmcs is not None:
        mask = np.zeros((pps.ctb_height, pps.ctb_width), np.int32)
        for rec, ctus in recon_jobs:
            if not rec.lmcs_used:
                continue
            for rs, rx, ry in ctus:
                mask[ry, rx] = 1
        if mask.any():
            meta["has_lmcs"] = True
            arrs["lmcs_lut"] = _up(np.asarray(lmcs.inv_lut, np.int32))
            arrs["lmcs_mask"] = _up(mask)
    # --- deblock segments ---
    for d, vertical in ((0, True), (1, False)):
        ras = rasterize_deblock(sps, pps, tabs, fb, slice_rpls, vertical)
        for c in range(nc):
            segs = ras.luma_segs if c == 0 else \
                (ras.chroma_segs.get(c) or [])
            meta[f"db{d}c{c}"] = bool(segs)
            if segs:
                # int16 on the wire: px/py < 2^15 for any level-supported
                # picture, tc <= 1580 (12-bit), beta <= 1408
                B = _pad_pow2(len(segs))
                a = np.zeros((7, B), np.int16)
                a[:, :len(segs)] = np.asarray(segs, np.int16).T
                arrs[f"db{d}c{c}"] = _up(a)
    # --- SAO ---
    sf = SaoFilter(sps, pps, tabs, fb)
    for c in range(nc):
        p = None
        if tabs.sao_type[:, c].any():
            p = _sao_ctb_params(sf, c, sps, pps, tabs)
        meta[f"sao{c}"] = p is not None
        if p is not None:
            for k, v in p.items():
                arrs[f"sao{c}_{k}"] = _up(v)
    # --- ALF ---
    for key in ("alf0", "alf1", "alf2", "cc1", "cc2"):
        meta[key] = False
    if sps.r.sps_alf_enabled_flag and sh_list is not None and \
            (tabs.alf_ctb_flag.any() or tabs.alf_cc_idc.any()):
        try:
            ap = _alf_ctb_params(sps, pps, tabs, sh_list, alf_list)
        except (KeyError, AttributeError, IndexError):
            return False    # missing APS etc: host fallback handles it
        for k, v in ap.items():
            arrs[k] = _up(v)
        H, W = pps.height, pps.width
        cs = sps.ctb_size_y
        if "alf0_set" in ap:
            meta["alf0"] = True
            r0, r3, s1, e3, ac = _cls_arrays(H, cs)
            arrs["cls_r0"] = _up(r0)
            arrs["cls_r3"] = _up(r3)
            arrs["blk_start1"] = _up(s1)
            arrs["blk_end3"] = _up(e3)
            arrs["blk_ac"] = _up(ac)
            rowsel, vbsel = _alf_vb_arrays(H, cs, ALF_BORDER_LUMA,
                                           ALF_VB_POS_ABOVE_LUMA, True)
            arrs["alf0_row"] = _up(rowsel)
            arrs["alf0_vb"] = _up(vbsel)
        if nc == 3:
            hs, vs = meta["hs"], meta["vs"]
            Hc = H >> vs
            if ("alf1_set" in ap) or ("alf2_set" in ap):
                rowsel, vbsel = _alf_vb_arrays(
                    Hc, cs >> vs, ALF_BORDER_CHROMA,
                    ALF_VB_POS_ABOVE_CHROMA, False)
                arrs["alfc_row"] = _up(rowsel)
                arrs["alfc_vb"] = _up(vbsel)
                meta["alf1"] = "alf1_set" in ap
                meta["alf2"] = "alf2_set" in ap
            if ("cc1_set" in ap) or ("cc2_set" in ap):
                rowsel, skip = _cc_arrays(Hc, cs, vs)
                arrs["cc_row"] = _up(rowsel)
                arrs["cc_skip"] = _up(skip)
                meta["cc1"] = "cc1_set" in ap
                meta["cc2"] = "cc2_set" in ap
    out = _chain(tuple(sorted(meta.items())), arrs)
    for c in range(nc):
        res = np.asarray(out[c])
        stats["down_bytes"] += res.nbytes
        fb.planes[c][:] = res
    stats["frames"] += 1
    stats["seconds"] += time.monotonic() - t0
    return True
