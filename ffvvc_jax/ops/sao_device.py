"""Device SAO: whole-frame band/edge offset filtering.

Whole-frame formulation of the reference's per-CTU SAO
(/root/reference/libavcodec/vvc/vvc_filter.c:154-298 and
h26x/h2656_sao_template.c): the host rasterizes the per-CTB SAO parameters
(type, band position / EO class, offsets, unfilterable-edge restore
regions) into per-pixel int32 maps, and a single elementwise pass per
plane (plain jitted XLA) applies the offsets.

Bit-exactness is pinned against the host golden (ffvvc_jax/sao.py) by
tests/test_device_filters.py.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..sao import SaoFilter, SAO_BAND, SAO_EDGE, _EDGE_IDX, _EO_POS

def _sao_math(src_pad, typ, m1, offs, keep, shift: int, pix_max: int):
    """Shared pixel math: src_pad [H+2, W+2], others [H, W] (offs [5, H, W]).
    Everything int32; returns filtered [H, W]."""
    cen = src_pad[1:-1, 1:-1]
    # edge-class neighbour differences for all 4 EO classes, select by m1
    a0, b0 = src_pad[1:-1, :-2], src_pad[1:-1, 2:]
    a1, b1 = src_pad[:-2, 1:-1], src_pad[2:, 1:-1]
    a2, b2 = src_pad[:-2, :-2], src_pad[2:, 2:]
    a3, b3 = src_pad[:-2, 2:], src_pad[2:, :-2]
    d0 = 2 + jnp.sign(cen - a0) + jnp.sign(cen - b0)
    d1 = 2 + jnp.sign(cen - a1) + jnp.sign(cen - b1)
    d2 = 2 + jnp.sign(cen - a2) + jnp.sign(cen - b2)
    d3 = 2 + jnp.sign(cen - a3) + jnp.sign(cen - b3)
    d = jnp.where(m1 == 0, d0,
                  jnp.where(m1 == 1, d1, jnp.where(m1 == 2, d2, d3)))
    edge_delta = sum(jnp.where(d == i, offs[i], 0) for i in range(5))
    # band: offsets cover 4 consecutive classes starting at m1 (mod 32)
    rel = ((cen >> shift) - m1) & 31
    band_delta = sum(jnp.where(rel == k, offs[k], 0) for k in range(4))
    delta = jnp.where(typ == SAO_BAND, band_delta,
                      jnp.where(typ == SAO_EDGE, edge_delta, 0))
    out = jnp.clip(cen + delta, 0, pix_max)
    return jnp.where(keep == 1, cen, out)


@functools.partial(jax.jit, static_argnames=("shift", "pix_max"))
def _sao_xla(src_pad, typ, m1, offs, keep, shift: int, pix_max: int):
    return _sao_math(src_pad, typ, m1, offs, keep, shift, pix_max)


def _rasterize_plane(sf: SaoFilter, c: int, plane):
    """Per-pixel SAO parameter maps for one plane, or None when SAO is off
    everywhere on it.  Mirrors the control flow of SaoFilter._sao_ctb."""
    sps, pps, tabs = sf.sps, sf.pps, sf.tabs
    H, W = plane.shape
    hs, vs = sps.hshift[c], sps.vshift[c]
    typ = np.zeros((H, W), np.int32)
    m1 = np.zeros((H, W), np.int32)
    offs = np.zeros((5, H, W), np.int32)
    keep = np.zeros((H, W), np.int32)
    any_on = False
    for ry in range(pps.ctb_height):
        for rx in range(pps.ctb_width):
            rs = ry * pps.ctb_width + rx
            t = int(tabs.sao_type[rs, c])
            if t == 0:
                continue
            any_on = True
            x0 = (rx << sps.ctb_log2_size_y) >> hs
            y0 = (ry << sps.ctb_log2_size_y) >> vs
            w = min(sps.ctb_size_y >> hs, W - x0)
            h = min(sps.ctb_size_y >> vs, H - y0)
            ys, xs = slice(y0, y0 + h), slice(x0, x0 + w)
            typ[ys, xs] = t
            off = tabs.sao_offset[rs, c]
            if t == SAO_BAND:
                m1[ys, xs] = int(tabs.sao_band_pos[rs, c])
                for k in range(4):
                    offs[k, ys, xs] = off[k + 1]
                continue
            eo = int(tabs.sao_eo_class[rs, c])
            m1[ys, xs] = eo
            for i in range(5):
                offs[i, ys, xs] = off[_EDGE_IDX[i]]
            # restore regions: identical slices to SaoFilter._sao_ctb
            restore, edges, vert_edge, horiz_edge, diag_edge = \
                sf._restore_flags(rx, ry)
            kblk = keep[ys, xs]
            init_x = init_y = 0
            rw, rh = w, h
            if eo != 1:       # SAO_EO_VERT
                if edges[0]:
                    kblk[:, 0] = 1
                    init_x = 1
                if edges[2]:
                    kblk[:, w - 1] = 1
                    rw = w - 1
            if eo != 0:       # SAO_EO_HORIZ
                if edges[1]:
                    kblk[0, init_x:rw] = 1
                if edges[3]:
                    kblk[h - 1, init_x:rw] = 1
                    rh = h - 1
            if restore:
                if eo != 0 and edges[1]:
                    init_y = 1
                sul = (not diag_edge[0] and eo == 2 and
                       not edges[0] and not edges[1])
                sur = (not diag_edge[1] and eo == 3 and
                       not edges[1] and not edges[2])
                slr = (not diag_edge[2] and eo == 2 and
                       not edges[2] and not edges[3])
                sll = (not diag_edge[3] and eo == 3 and
                       not edges[0] and not edges[3])
                if vert_edge[0] and eo != 1:
                    kblk[init_y + sul:rh - sll, 0] = 1
                if vert_edge[1] and eo != 1:
                    kblk[init_y + sur:rh - slr, w - 1] = 1
                if horiz_edge[0] and eo != 0:
                    kblk[0, init_x + sul:rw - sur] = 1
                if horiz_edge[1] and eo != 0:
                    kblk[h - 1, init_x + sll:rw - slr] = 1
    if not any_on:
        return None
    return typ, m1, offs, keep


def sao_frame_device(sps, pps, tabs, fb):
    """Device SAO over all planes of a frame, in place on fb.planes."""
    if not any(int(t) for t in tabs.sao_type.flat):
        return
    sf = SaoFilter(sps, pps, tabs, fb)
    shift = sps.bit_depth - 5
    pix_max = (1 << sps.bit_depth) - 1
    nc = 3 if sps.chroma_format_idc else 1
    launched = []
    for c in range(nc):
        plane = fb.planes[c]
        maps = _rasterize_plane(sf, c, plane)
        if maps is None:
            continue
        typ, m1, offs, keep = maps
        src_pad = np.pad(plane, 1, mode="edge").astype(np.int32)
        out = _sao_xla(jnp.asarray(src_pad), jnp.asarray(typ),
                       jnp.asarray(m1), jnp.asarray(offs), jnp.asarray(keep),
                       shift, pix_max)
        launched.append((c, out))
    for c, out in launched:
        fb.planes[c][:] = np.asarray(out)
