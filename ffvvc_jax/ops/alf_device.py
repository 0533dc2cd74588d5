"""Device ALF / CC-ALF: whole-frame clipped-diamond filtering.

Whole-frame formulation of the reference's per-CTU ALF
(/root/reference/libavcodec/vvc/vvc_filter.c:1254-1320 and the AVX2 kernels
of x86/vvc/vvc_alf.asm): the host rasterizes, per plane, the virtual-
boundary/clamp-resolved tap sample planes plus per-pixel coefficient and
clip maps (reusing the golden AlfFilter's window/classification logic), and
a single elementwise pass applies the 12-tap clipped filter.  Chroma's
5x5 diamond (6 taps) is a geometric subset of luma's 7x7 diamond (12 taps),
so one kernel serves both; all-zero coefficients are an exact identity, so
unfiltered CTBs need no masking.  CC-ALF is a second 7-tap pass over
luma-sampled positions.  Classification stays on the host (sequential
4x4-block decision tree; its output is the per-pixel coeff map).

The pixel math is plain jitted XLA.  Bit-exactness is pinned against
the host golden (ffvvc_jax/alf.py) by tests/test_device_filters.py.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..alf import (AlfFilter, ALF_BORDER_LUMA, ALF_BORDER_CHROMA,
                   ALF_VB_POS_ABOVE_LUMA, ALF_VB_POS_ABOVE_CHROMA,
                   ALF_NUM_COEFF_LUMA, ALF_NUM_COEFF_CHROMA,
                   ALF_NUM_FILTERS_LUMA, _TRANSPOSE_IDX)
from . import data as D

# luma 7x7-diamond tap geometry: (row_key_a, dx_a, row_key_b, dx_b) per
# coefficient, row keys indexing the VB-resolved row planes 0..6
# (0:+0, 1:+1, 2:-1, 3:+2, 4:-2, 5:+3, 6:-3) — alf.py _filter_luma taps
_LUMA_TAPS = ((5, 0, 6, 0), (3, 1, 4, -1), (3, 0, 4, 0), (3, -1, 4, 1),
              (1, 2, 2, -2), (1, 1, 2, -1), (1, 0, 2, 0), (1, -1, 2, 1),
              (1, -2, 2, 2), (0, 3, 0, -3), (0, 2, 0, -2), (0, 1, 0, -1))
# chroma 5x5-diamond taps mapped onto the luma tap slots (alf.py
# _filter_chroma taps k -> luma slot)
_CHROMA_SLOT = (2, 5, 6, 7, 10, 11)


def _alf_math(cur, v0, v1, cf, cl, vb_sel, pix_max: int):
    """Shared pixel math: cur [H, W]; v0/v1/cf/cl [12, H, W]; vb_sel [H, W]
    (1 near the virtual boundary -> shift 10).  Everything int32."""
    d = jnp.clip(v0 - cur, -cl, cl) + jnp.clip(v1 - cur, -cl, cl)
    acc = (cf * d).sum(axis=0)
    acc = jnp.where(vb_sel == 1, (acc + (1 << 9)) >> 10, (acc + 64) >> 7)
    return jnp.clip(cur + acc, 0, pix_max)


def _cc_math(dst, cur, v, cf, half: int, pix_max: int):
    """CC-ALF: dst/cur [H, W]; v/cf [7, H, W]; cur is the collocated luma."""
    acc = (cf * (v - cur)).sum(axis=0)
    acc = jnp.clip((acc + 64) >> 7, -half, half - 1)
    return jnp.clip(dst + acc, 0, pix_max)


@functools.partial(jax.jit, static_argnames=("pix_max",))
def _alf_xla(cur, v0, v1, cf, cl, vb_sel, pix_max: int):
    return _alf_math(cur, v0, v1, cf, cl, vb_sel, pix_max)


@functools.partial(jax.jit, static_argnames=("half", "pix_max"))
def _cc_xla(dst, cur, v, cf, half: int, pix_max: int):
    return _cc_math(dst, cur, v, cf, half, pix_max)


def _vb_row_offsets(h, vb_pos, is_luma):
    """VB-resolved row-plane offsets o[k][y] for k = 0..6 (alf.py
    _filter_luma/_filter_chroma row-substitution), vectorized over y.
    The outer gating ranges differ: luma [vb-4, vb) / [vb, vb+3], chroma
    [vb-2, vb) / [vb, vb+1]; the inner substitutions are identical."""
    ys = np.arange(h)
    o = np.broadcast_to(np.array([0, 1, -1, 2, -2, 3, -3])[:, None],
                        (7, h)).copy()
    below_lo = vb_pos - (4 if is_luma else 2)
    above_hi = vb_pos + (3 if is_luma else 1)
    bel = (ys >= below_lo) & (ys < vb_pos)
    abv = (ys >= vb_pos) & (ys <= above_hi)
    m = bel & (ys == vb_pos - 1)
    o[1][m] = 0
    o[2][m] = 0
    m = bel & (ys >= vb_pos - 2)
    o[3][m] = o[1][m]
    o[4][m] = o[2][m]
    m = bel & (ys >= vb_pos - 3)
    o[5][m] = o[3][m]
    o[6][m] = o[4][m]
    m = abv & (ys == vb_pos)
    o[2][m] = 0
    o[1][m] = 0
    m = abv & (ys <= vb_pos + 1)
    o[4][m] = o[2][m]
    o[3][m] = o[1][m]
    m = abv & (ys <= vb_pos + 2)
    o[6][m] = o[4][m]
    o[5][m] = o[3][m]
    return o


class _AlfRasterizer(AlfFilter):
    """Rasterizes the per-CTB ALF decisions into whole-frame tap-sample /
    coefficient / clip planes consumed by the device pass.  Reuses the
    golden AlfFilter's edge/window/classification machinery verbatim."""

    def rasterize(self):
        sps, pps, tabs = self.sps, self.pps, self.tabs
        t = D.tables()
        pre = [np.asarray(p) for p in self.fb.planes]
        nc = 3 if sps.chroma_format_idc else 1
        out = {}
        for c in range(nc):
            H, W = pre[c].shape
            if not tabs.alf_ctb_flag[:, c].any():
                out[c] = None
            else:
                out[c] = dict(
                    cur=pre[c].astype(np.int32),
                    v0=np.zeros((12, H, W), np.int32),
                    v1=np.zeros((12, H, W), np.int32),
                    cf=np.zeros((12, H, W), np.int32),
                    cl=np.ones((12, H, W), np.int32),
                    vb=np.zeros((H, W), np.int32))
            if c and tabs.alf_cc_idc[:, c - 1].any():
                out[("cc", c)] = dict(
                    v=np.zeros((7, H, W), np.int32),
                    curl=np.zeros((H, W), np.int32),
                    cf=np.zeros((7, H, W), np.int32))
        for ry in range(pps.ctb_height):
            for rx in range(pps.ctb_width):
                self._raster_ctb(rx, ry, pre, out, t)
        return out

    def _gather_taps(self, win, w, h, b, vb_pos, taps, slots, dst_v0,
                     dst_v1, ys, xs):
        o = _vb_row_offsets(h, vb_pos, b == ALF_BORDER_LUMA)
        # row plane k of the window per output row: win[b + y + o[k][y]]
        yy = np.arange(h)
        for slot, (ka, da, kb, db) in zip(slots, taps):
            ra = win[(b + yy + o[ka])[:, None],
                     np.arange(b + da, b + da + w)[None, :]]
            rb = win[(b + yy + o[kb])[:, None],
                     np.arange(b + db, b + db + w)[None, :]]
            dst_v0[slot][ys, xs] = ra
            dst_v1[slot][ys, xs] = rb

    def _raster_ctb(self, rx, ry, pre, out, t):
        sps, pps, tabs = self.sps, self.pps, self.tabs
        rs = ry * pps.ctb_width + rx
        rsh = self.sh_list[int(tabs.slice_idx[ry, rx])].r
        edges = self._edges(rx, ry)
        nc = 3 if sps.chroma_format_idc else 1
        luma_win = None
        for c in range(nc):
            hs, vs = sps.hshift[c], sps.vshift[c]
            x0 = (rx << sps.ctb_log2_size_y) >> hs
            y0 = (ry << sps.ctb_log2_size_y) >> vs
            w = min((pps.width >> hs) - x0, sps.ctb_size_y >> hs)
            h = min((pps.height >> vs) - y0, sps.ctb_size_y >> vs)
            ctb_size_v = sps.ctb_size_y >> vs
            flag = int(tabs.alf_ctb_flag[rs, c])
            cc_idc = int(tabs.alf_cc_idc[rs, c - 1]) if c else 0
            if c == 0 and (flag or tabs.alf_cc_idc[rs].any()):
                luma_win = self._window(pre[0], x0, y0, w, h,
                                        ALF_BORDER_LUMA, edges)
            if not flag and not cc_idc:
                continue
            ys = slice(y0, y0 + h)
            xs = slice(x0, x0 + w)
            if flag and c == 0:
                m = out[0]
                vb_pos = ctb_size_v - ALF_VB_POS_ABOVE_LUMA
                ci, ti = self._classify(luma_win, w, h, vb_pos)
                if tabs.alf_fixed[rs]:
                    coeff_set = t["alf_fix_filt_coeff"].astype(np.int64)
                    clip_idx_set = np.zeros((ALF_NUM_FILTERS_LUMA,
                                             ALF_NUM_COEFF_LUMA), np.int64)
                    class_to_filt = t["alf_class_to_filt_map"][
                        int(tabs.alf_filt_idx[rs])]
                else:
                    aps_alf = self.alf_list[int(tabs.alf_aps_id[rs, 0])]
                    coeff_set = aps_alf.luma_coeff
                    clip_idx_set = aps_alf.luma_clip_idx
                    class_to_filt = t["alf_aps_class_to_filt_map"]
                clip_set = np.array(
                    [1 << sps.bit_depth, 1 << (sps.bit_depth - 3),
                     1 << (sps.bit_depth - 5), 1 << (sps.bit_depth - 7)],
                    np.int64)
                perm = np.asarray(_TRANSPOSE_IDX)[ti]          # [nby,nbx,12]
                src_c = coeff_set[class_to_filt[ci]]           # [nby,nbx,12]
                src_cl = clip_idx_set[0] + np.zeros_like(src_c) \
                    if tabs.alf_fixed[rs] else clip_idx_set[ci]
                coeff = np.take_along_axis(src_c, perm, axis=2)
                clip = clip_set[np.take_along_axis(src_cl, perm, axis=2)]
                # expand per-4x4 -> per-pixel
                cfp = np.repeat(np.repeat(coeff, 4, 0), 4, 1)[:h, :w]
                clp = np.repeat(np.repeat(clip, 4, 0), 4, 1)[:h, :w]
                m["cf"][:, ys, xs] = np.moveaxis(cfp, 2, 0)
                m["cl"][:, ys, xs] = np.moveaxis(clp, 2, 0)
                yy = np.arange(h)
                near = ((yy >= vb_pos - 1) & (yy <= vb_pos)).astype(np.int32)
                m["vb"][ys, xs] = near[:, None]
                self._gather_taps(luma_win, w, h, ALF_BORDER_LUMA, vb_pos,
                                  _LUMA_TAPS, range(12), m["v0"], m["v1"],
                                  ys, xs)
            elif flag:
                m = out[c]
                aps_alf = self.alf_list[rsh.sh_alf_aps_id_chroma]
                alt = int(tabs.alf_alt_idx[rs, c - 1])
                win = self._window(pre[c], x0, y0, w, h, ALF_BORDER_CHROMA,
                                   edges)
                off = (0, 3, 5, 7)
                vb_pos = ctb_size_v - ALF_VB_POS_ABOVE_CHROMA
                for k, slot in enumerate(_CHROMA_SLOT):
                    m["cf"][slot, ys, xs] = \
                        int(aps_alf.chroma_coeff[alt][k])
                    m["cl"][slot, ys, xs] = 1 << (
                        sps.bit_depth -
                        off[int(aps_alf.chroma_clip_idx[alt][k])])
                yy = np.arange(h)
                near = ((yy >= vb_pos - 1) & (yy <= vb_pos)).astype(np.int32)
                m["vb"][ys, xs] = near[:, None]
                taps = tuple(_LUMA_TAPS[s] for s in _CHROMA_SLOT)
                self._gather_taps(win, w, h, ALF_BORDER_CHROMA, vb_pos,
                                  taps, _CHROMA_SLOT, m["v0"], m["v1"],
                                  ys, xs)
            if c and cc_idc:
                cc_aps_id = rsh.sh_alf_cc_cb_aps_id if c == 1 else \
                    rsh.sh_alf_cc_cr_aps_id
                aps_alf = self.alf_list.get(cc_aps_id)
                if aps_alf is not None:
                    m = out[("cc", c)]
                    coeff = aps_alf.cc_coeff[c - 1][cc_idc - 1]
                    vb = (ctb_size_v << vs) - ALF_VB_POS_ABOVE_LUMA
                    self._raster_cc(m, luma_win, x0, y0, w, h, hs, vs,
                                    coeff, vb)

    def _raster_cc(self, m, luma_win, x0, y0, w, h, hs, vs, coeff, vb_pos):
        """CC-ALF tap planes (alf.py _filter_cc row/tap geometry)."""
        b = ALF_BORDER_LUMA
        yy = np.arange(h)
        pos = yy << vs
        skip = (vs == 0) & ((pos == vb_pos) | (pos == vb_pos + 1))
        r0 = pos - 1
        r1 = pos.copy()
        r2 = pos + 1
        r3 = pos + 2
        mm = (pos == vb_pos - 2) | (pos == vb_pos + 1)
        r3 = np.where(mm, r2, r3)
        mm = (pos == vb_pos - 1) | (pos == vb_pos)
        r3 = np.where(mm, r1, r3)
        r2 = np.where(mm, r1, r2)
        r0 = np.where(mm, r1, r0)
        xs_l = (np.arange(w) << hs) + b
        ys = slice(y0, y0 + h)
        xs = slice(x0, x0 + w)
        cur = luma_win[(b + r1)[:, None], xs_l[None, :]]
        taps = ((r0, 0), (r1, -1), (r1, 1), (r2, -1), (r2, 0), (r2, 1),
                (r3, 0))
        for j, (rr, dx) in enumerate(taps):
            m["v"][j][ys, xs] = luma_win[(b + rr)[:, None],
                                         (xs_l + dx)[None, :]]
            cfj = np.where(skip, 0, int(coeff[j])).astype(np.int32)
            m["cf"][j][ys, xs] = cfj[:, None]
        m["curl"][ys, xs] = cur


def alf_frame_device(sps, pps, tabs, fb, sh_list, alf_list):
    """Device ALF + CC-ALF over all planes of a frame, in place."""
    if not sps.r.sps_alf_enabled_flag:
        return
    if not tabs.alf_ctb_flag.any() and not tabs.alf_cc_idc.any():
        return
    ras = _AlfRasterizer(sps, pps, tabs, fb, sh_list, alf_list)
    maps = ras.rasterize()
    pix_max = (1 << sps.bit_depth) - 1
    half = 1 << (sps.bit_depth - 1)
    nc = 3 if sps.chroma_format_idc else 1
    launched = []
    for c in range(nc):
        m = maps.get(c)
        if m is None:
            continue
        res = _alf_xla(jnp.asarray(m["cur"]), jnp.asarray(m["v0"]),
                       jnp.asarray(m["v1"]), jnp.asarray(m["cf"]),
                       jnp.asarray(m["cl"]), jnp.asarray(m["vb"]), pix_max)
        launched.append((c, res))
    # ALF writes must land before CC-ALF reads dst (but CC reads pre-ALF
    # LUMA, which is unaffected by this plane loop: luma_win snapshots)
    for c, res in launched:
        fb.planes[c][:] = np.asarray(res)
    cc_launched = []
    for c in (1, 2):
        m = maps.get(("cc", c))
        if m is None:
            continue
        dst = fb.planes[c].astype(np.int32)
        res = _cc_xla(jnp.asarray(dst), jnp.asarray(m["curl"]),
                      jnp.asarray(m["v"]), jnp.asarray(m["cf"]), half,
                      pix_max)
        cc_launched.append((c, res))
    for c, res in cc_launched:
        fb.planes[c][:] = np.asarray(res)
