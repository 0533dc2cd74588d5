"""Device intra prediction: wavefront-batched, bit-exact.

Wavefront-batched formulation of the reference's intra reconstruction
(/root/reference/libavcodec/vvc/vvc_intra.c:119-263 recon walk,
vvc_intra_template.c:467-1015 edge prep + predictors): intra prediction is
the one kernel family whose data dependencies (each block predicts from its
reconstructed left/top neighbours) fight batching.  The design splits it:

* A host PLANNER walks the parsed CU records in decode order and, for each
  predict unit, resolves every scalar decision the reference makes at
  prediction time — availability/substitution of reference samples
  (prepare_intra_edge_params), wide-angle mapping, MRL reference lines,
  reference-filter decisions, projection of the side reference for angular
  modes — into pure GATHER INDEX arrays into the frame plane plus masks.
  Substitution and projection are value *copies* in the reference, so in
  index space they are index copies; only the [1 2 1] smoothing filter and
  the predictors themselves touch sample values, and those run on device.
  The planner also assigns each unit a WAVE: 1 + max wave over the units
  producing its reference samples (the per-sample analogue of the
  reference's per-CTU progress stencil, vvc_thread.c:321-326).

* DEVICE kernels then execute wave by wave: units of one wave are mutually
  independent and batch by (kind, w, h) into single launches — gather
  refs from the device-resident plane, filter, predict (planar/DC/angular
  incl. PDPC, MIP as a batched matmul, CCLM with on-device parameter
  derivation), add the precomputed residual window and scatter the clipped
  result back into the plane.  Residuals have no recon dependency and are
  produced up front by the native record walk in residual-only mode
  (native/vvc_recon.c recon_residual_ctus).

Bit-exact vs the golden model / reference oracle (integer-only math),
pinned by tests/test_device_intra.py across all chroma formats
(mono/4:2:0/4:2:2/4:4:4) and 8/10/12-bit.  Gated to all-intra frames
(DecoderConfig.device_intra); inter frames use the native C walk.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from . import data as D
from .mc_device import MIN_BATCH
from ..recon import (Reconstructor, wide_angle_map, intra_pred_angle,
                     intra_inv_angle, need_pdpc, nscale_derive, is_cclm)
from ..ctu import (MODE_INTRA, INTRA_PLANAR, INTRA_DC, INTRA_HORZ,
                   INTRA_VERT, INTRA_DIAG, INTRA_LT_CCLM, INTRA_T_CCLM,
                   ISP_NO_SPLIT)

PAD = 68          # negative-index headroom (golden _edge_params PAD)
NREF = 288        # per-side reference array length (PAD + 2*64 + extra)

K_SIMPLE, K_ANG_V, K_ANG_H, K_MIP, K_CCLM = range(5)


class _Unit:
    __slots__ = ("kind", "c_idx", "x", "y", "w", "h", "wave",
                 "Lidx", "Tidx", "fmL", "fmT", "projL", "projT",
                 "sel", "pdpc", "angle", "inv_angle", "ref_idx", "ff",
                 "nscale", "mip_mode", "mip_t", "cclm", "plane_sel")


def records_to_cus(nr, rs):
    """Rebuild CodingUnit objects (pred-side fields only, no coefficient
    copies) from the flat arena records of one CTU — the planner walks the
    same objects the golden model does."""
    from ..native.parse import CU_STRIDE
    from ..ctu import CodingUnit, TransformUnit
    from ..residual import TransformBlock
    rec = nr.records.get(rs)
    if rec is None or not rec[0]:
        return []
    n_cu, cu_p, _tu_p, _tb_p, _co_p, arena = rec
    pv = cu_p.value if hasattr(cu_p, "value") else cu_p
    cu_start = (int(pv) - arena.cu.ctypes.data) // (CU_STRIDE * 4)
    crows = arena.cu[cu_start:cu_start + n_cu].tolist()
    tus_arr = arena.tu
    tbs_arr = arena.tb
    out = []
    for c in crows:
        cu = CodingUnit(c[0], c[1], c[2], c[3], c[4], c[5])
        cu.pred_mode = c[6]
        cu.coded_flag = c[8]
        cu.intra_pred_mode_y = c[9]
        cu.intra_pred_mode_c = c[10]
        cu.intra_luma_ref_idx = c[11]
        cu.intra_mip_flag = c[12]
        cu.mip_transposed = c[13]
        cu.mip_mode = c[14]
        cu.isp_split_type = c[15]
        cu.num_intra_subpartitions = c[16]
        cu.bdpcm_flag = [c[17], c[18], c[19]]
        cu.mip_chroma_direct_flag = c[20]
        for t in tus_arr[c[27]:c[27] + c[28]].tolist():
            tu = TransformUnit(t[0], t[1], t[2], t[3])
            tu.coded_flag = [t[4], t[5], t[6]]
            cu.tus.append(tu)
            for b in tbs_arr[t[8]:t[8] + t[9]].tolist():
                tb = TransformBlock(b[0], b[1], b[2], b[3], b[4])
                tu.tbs.append(tb)
        out.append(cu)
    return out


class IntraPlanner(Reconstructor):
    """Walks CUs exactly like the golden Reconstructor (same availability,
    same predict-unit decomposition) but emits unit descriptors + gather
    plans instead of pixels."""

    def __init__(self, rec, shared):
        super().__init__(rec.sps, rec.pps, rec.tabs, rec.fb, rec.nbr)
        self.sh = shared     # dict: units, wmap (per ch), geometry
        self._wl = shared["wl"]          # luma wave map [H, W] int32
        self._wc = shared.get("wc")      # chroma wave map [Hc, Wc]
        self._ilib = None    # never shortcut to the C predictor

    # residuals are produced by the C residual-only walk
    def itransform(self, cu, tu, tu_idx, target_ch_type):
        pass

    def plan_ctu(self, rs, rx, ry, cus):
        log2 = self.sps.ctb_log2_size_y
        self.nbr.decode_neighbour(rx << log2, ry << log2, rx, ry, rs)
        self.ras = [[], []]
        for cu in cus:
            self.reconstruct_cu(cu)

    # --- unit emission ----------------------------------------------------

    def _emit(self, u, ref_idx_arrays):
        """Assign the wave from the gather plan and record the unit."""
        wmap = self._wl if u.c_idx == 0 else self._wc
        wm = wmap.reshape(-1)
        wave = 0
        nplane = wm.shape[0]
        for idx in ref_idx_arrays:
            v = idx[idx >= 0] % nplane if u.c_idx else idx[idx >= 0]
            if len(v):
                wave = max(wave, int(wm[v].max()))
        u.wave = wave + 1
        wmap[u.y:u.y + u.h, u.x:u.x + u.w] = u.wave
        self.sh["units"].append(u)
        return u

    def _plane_base(self, c_idx):
        """Flat-index base: chroma planes are stacked [2, Hc, Wc]."""
        if c_idx == 0:
            return 0
        Hc, Wc = self.fb.planes[1].shape
        return (c_idx - 1) * Hc * Wc

    def _edge_plan(self, x, y, w, h, c_idx, geom, la, ta, cand_up_left):
        """Index-domain twin of the golden _edge_params fill+substitution
        (recon.py:670-703): each reference sample becomes a flat plane
        index (-1 => mid-value), substitutions copy indices."""
        (rff, fsm, ref_line, refw, refh, left_size, top_size,
         unf_left, unf_top, angle, inv_angle) = geom
        W = self.fb.planes[0].shape[1] if c_idx == 0 \
            else self.fb.planes[1].shape[1]
        base = self._plane_base(c_idx)
        Lidx = np.full(NREF, -1, np.int64)
        Tidx = np.full(NREF, -1, np.int64)
        P = PAD
        if la:
            Lidx[P:P + la] = base + (y + np.arange(la)) * W + (x + ref_line)
        if ta:
            Tidx[P:P + ta] = base + (y + ref_line) * W + x + np.arange(ta)
        for i in range(-1, ref_line - 1, -1):
            if cand_up_left:
                Lidx[P + i] = base + (y + i) * W + (x + ref_line)
                Tidx[P + i] = base + (y + ref_line) * W + (x + i)
            elif la:
                Lidx[P + i] = Tidx[P + i] = Lidx[P]
            elif ta:
                Lidx[P + i] = Tidx[P + i] = Tidx[P]
        if ta < unf_top:
            Tidx[P + ta:P + unf_top] = Tidx[P + ta - 1] if ta \
                else Tidx[P - 1]
        if la < unf_left:
            Lidx[P + la:P + unf_left] = Lidx[P + la - 1] if la \
                else Lidx[P - 1]
        fmL = np.zeros(NREF, np.bool_)
        fmT = np.zeros(NREF, np.bool_)
        if rff and fsm:
            ul = int(left_size == unf_left)
            fmL[P - 1] = fmT[P - 1] = True
            fmL[P:P + unf_left - ul] = True
            fmT[P:P + unf_top - ul] = True
        return Lidx, Tidx, fmL, fmT

    def _proj_plan(self, mode, ref_idx, w, h, geom):
        """Index-domain twin of the angular side-projection
        (recon.py:717-734): composition indices into concat(fL, fT)."""
        (_rff, _fsm, _rl, refw, refh, _ls, _ts, _ul, _ut,
         angle, inv_angle) = geom
        projL = np.arange(NREF, dtype=np.int64)
        projT = NREF + np.arange(NREF, dtype=np.int64)
        if mode >= INTRA_DIAG:
            if angle < 0:
                xxs = np.arange(-h, 0)
                idxs = -1 - ref_idx + np.minimum(
                    (xxs * inv_angle + 256) >> 9, h)
                projT[PAD + xxs - (ref_idx + 1)] = PAD + idxs      # from fL
            else:
                lo, hi = refw, refw + max(1, w // h) * ref_idx + 2
                projT[PAD + lo:PAD + hi] = NREF + PAD + refw - 1
        else:
            if angle < 0:
                xxs = np.arange(-w, 0)
                idxs = -1 - ref_idx + np.minimum(
                    (xxs * inv_angle + 256) >> 9, w)
                projL[PAD + xxs - (ref_idx + 1)] = NREF + PAD + idxs
            else:
                lo, hi = refh, refh + max(1, h // w) * ref_idx + 2
                projL[PAD + lo:PAD + hi] = PAD + refh - 1
        return projL, projT

    def intra_pred(self, cu, x0, y0, width, height, c_idx):
        sps = self.sps
        hs, vs = sps.hshift[c_idx], sps.vshift[c_idx]
        x, y = x0 >> hs, y0 >> vs
        w, h = width >> hs, height >> vs
        pred_mode = cu.intra_pred_mode_c if c_idx else cu.intra_pred_mode_y
        mode = wide_angle_map(cu, w, h, c_idx, pred_mode)
        xc4, yc4 = x0 >> 2, y0 >> 2
        intra_mip = int(self.tabs.imf[yc4, xc4])
        is_mip = intra_mip and (not c_idx or cu.mip_chroma_direct_flag)
        ref_idx = 0 if c_idx else cu.intra_luma_ref_idx
        pdpc = need_pdpc(w, h, cu.bdpcm_flag[c_idx], mode, ref_idx) \
            if not is_mip else 0
        geom = self._edge_geometry(cu, w, h, c_idx, is_mip, mode, ref_idx,
                                   pdpc)
        (rff, fsm, _rl, _refw, _refh, _ls, _ts, unf_left, unf_top,
         angle, inv_angle) = geom
        la = self.get_left_available(x, y, unf_left, c_idx)
        ta = self.get_top_available(x, y, unf_top, c_idx)
        cul = self.nbr.na.cand_up_left
        ff = self._filter_flag(cu, w, h, is_mip, mode, rff, ref_idx)

        u = _Unit()
        u.c_idx, u.x, u.y, u.w, u.h = c_idx, x, y, w, h
        u.plane_sel = max(0, c_idx - 1)
        u.Lidx, u.Tidx, u.fmL, u.fmT = self._edge_plan(
            x, y, w, h, c_idx, geom, la, ta, cul)
        u.ref_idx, u.ff, u.pdpc = ref_idx, ff, pdpc
        u.angle, u.inv_angle = angle, inv_angle
        u.nscale = 0
        u.projL = u.projT = None
        if is_mip:
            u.kind = K_MIP
            u.mip_mode = int(self.tabs.imm[yc4, xc4])
            u.mip_t = int(self.tabs.imtf[yc4, xc4])
        elif mode in (INTRA_PLANAR, INTRA_DC, INTRA_VERT, INTRA_HORZ):
            u.kind = K_SIMPLE
            u.sel = {INTRA_PLANAR: 0, INTRA_DC: 1, INTRA_VERT: 2,
                     INTRA_HORZ: 3}[mode]
        else:
            u.kind = K_ANG_V if mode >= INTRA_DIAG else K_ANG_H
            u.projL, u.projT = self._proj_plan(mode, ref_idx, w, h, geom)
            if pdpc:
                u.nscale = nscale_derive(w, h, mode)
        self._emit(u, [u.Lidx, u.Tidx])

    def cclm_pred(self, cu, x0, y0, width, height):
        sps = self.sps
        hs, vs = sps.hshift[1], sps.vshift[1]
        x, y = x0 >> hs, y0 >> vs
        w, h = width >> hs, height >> vs
        avail_t = self.get_top_available(x0, y0, 1, 0)
        avail_l = self.get_left_available(x0, y0, 1, 0)
        u = _Unit()
        u.kind = K_CCLM
        u.c_idx, u.x, u.y, u.w, u.h = 1, x, y, w, h
        u.plane_sel = 0
        u.cclm = self._cclm_plan(cu, x0, y0, w, h, avail_t, avail_l)
        # wave: depends on chroma neighbours + the collocated/neighbour luma
        Hc, Wc = self.fb.planes[1].shape
        wl = self._wl
        wc = self._wc
        wave = 0
        for (ly, lx) in u.cclm["luma_rects"]:
            wave = max(wave, int(wl[ly, lx].max()) if ly.size else 0)
        ci = u.cclm["selC_idx"]
        v = ci[ci >= 0] % (Hc * Wc)
        if len(v):
            wave = max(wave, int(wc.reshape(-1)[v].max()))
        u.wave = wave + 1
        wc[y:y + h, x:x + w] = u.wave
        self.sh["units"].append(u)

    def _cclm_plan(self, cu, x0, y0, w, h, avail_t, avail_l):
        """Host plan for CCLM: neighbour-sample tap plans (index+weight),
        chroma sample positions, and the collocated-luma downsample gather
        vectors (index-domain twins of recon.py:462-561)."""
        sps = self.sps
        hs, vs = sps.hshift[1], sps.vshift[1]
        x, y = x0 >> hs, y0 >> vs
        Hl, Wl = self.fb.planes[0].shape
        Hc, Wc = self.fb.planes[1].shape
        plan = {"noneigh": 0}
        mid = 1 << (sps.bit_depth - 1)

        # ---- collocated luma downsample gather vectors (per-pixel rows /
        # cols in luma coords; variant chosen statically per bucket)
        if not hs and not vs:
            xm1 = x0 + np.arange(w)      # unused (444 direct window)
            xc = x0 + np.arange(w)
            r0 = y0 + np.arange(h)
            rt = r0
        else:
            xm1 = x0 + 2 * np.arange(w) - 1
            xm1[0] = x0 - avail_l
            xc = x0 + 2 * np.arange(w)
            if not vs:
                r0 = y0 + np.arange(h)
                rt = r0
            else:
                r0 = y0 + 2 * np.arange(h)
                rt = r0 - 1
                rt[0] = y0 - avail_t
        # clamp only the tap offsets a variant actually reads: the 4:2:0
        # variants access r0+1, the subsampled-h variants access xc+1
        plan["xm1"] = np.clip(xm1, 0, Wl - 1)
        plan["xc"] = np.clip(xc, 0, Wl - 1 if (not hs and not vs)
                             else max(Wl - 2, 0))
        plan["r0"] = np.clip(r0, 0, Hl - 1 if not vs else max(Hl - 2, 0))
        plan["rt"] = np.clip(rt, 0, Hl - 1)
        plan["luma_rects"] = [(plan["r0"][:, None], plan["xc"][None, :])]

        if not avail_t and not avail_l:
            plan["noneigh"] = 1
            plan["selY_idx"] = np.zeros((4, 6), np.int64)
            plan["selY_w"] = np.zeros((4, 6), np.int64)
            plan["selY_add"] = np.zeros(4, np.int64)
            plan["selY_sh"] = np.zeros(4, np.int64)
            plan["selC_idx"] = np.full((2, 4), -1, np.int64)
            plan["mid"] = mid
            return plan

        sp = self._cclm_select_pos(cu, x, y, w, h, avail_t, avail_l)
        if sp is None:
            plan["noneigh"] = 1
            plan["selY_idx"] = np.zeros((4, 6), np.int64)
            plan["selY_w"] = np.zeros((4, 6), np.int64)
            plan["selY_add"] = np.zeros(4, np.int64)
            plan["selY_sh"] = np.zeros(4, np.int64)
            plan["selC_idx"] = np.full((2, 4), -1, np.int64)
            plan["mid"] = mid
            return plan
        cnt, pos = sp

        # ---- luma tap plans per selected neighbour sample
        taps = []        # (idx[6], w[6], add, sh)
        coll = sps.r.sps_chroma_vertical_collocated_flag
        b_ctu_boundary = not (y0 & ((1 << sps.ctb_log2_size_y) - 1))

        def lflat(yy, xx):
            return yy * Wl + xx

        if not hs and not vs:
            for p in pos[0]:
                taps.append(([lflat(y0 - avail_t, x0 + p)] + [0] * 5,
                             [1, 0, 0, 0, 0, 0], 0, 0))
            for p in pos[1]:
                taps.append(([lflat(y0 + p, x0 - avail_l)] + [0] * 5,
                             [1, 0, 0, 0, 0, 0], 0, 0))
        else:
            for p in pos[0]:        # top row(s)
                xx = p << hs
                xl = x0 + xx - 1 if (xx or avail_l) else x0 + xx
                if vs and not b_ctu_boundary:
                    yb = y0 - 2
                    if coll:
                        taps.append((
                            [lflat(yb - 1, x0 + xx), lflat(yb, xl),
                             lflat(yb, x0 + xx), lflat(yb, x0 + xx + 1),
                             lflat(yb + 1, x0 + xx), 0],
                            [1, 1, 4, 1, 1, 0], 4, 3))
                    else:
                        taps.append((
                            [lflat(yb, xl), lflat(yb + 1, xl),
                             lflat(yb, x0 + xx), lflat(yb + 1, x0 + xx),
                             lflat(yb, x0 + xx + 1),
                             lflat(yb + 1, x0 + xx + 1)],
                            [1, 1, 2, 2, 1, 1], 4, 3))
                else:
                    yb = y0 - 1
                    taps.append((
                        [lflat(yb, xl), lflat(yb, x0 + xx),
                         lflat(yb, x0 + xx + 1), 0, 0, 0],
                        [1, 2, 1, 0, 0, 0], 2, 2))
            x_src = x0 - (1 + hs) * avail_l
            x_l = x_src - avail_l
            for p in pos[1]:        # left column
                yy = y0 + (p << vs)
                if not vs:
                    taps.append((
                        [lflat(yy, x_l), lflat(yy, x_src),
                         lflat(yy, x_src + 1), 0, 0, 0],
                        [1, 2, 1, 0, 0, 0], 2, 2))
                elif coll:
                    ty = yy - 1 if ((p << vs) or avail_t) else yy
                    taps.append((
                        [lflat(yy, x_l), lflat(ty, x_src),
                         lflat(yy, x_src), lflat(yy, x_src + 1),
                         lflat(yy + 1, x_src), 0],
                        [1, 1, 4, 1, 1, 0], 4, 3))
                else:
                    taps.append((
                        [lflat(yy, x_l), lflat(yy + 1, x_l),
                         lflat(yy, x_src), lflat(yy + 1, x_src),
                         lflat(yy, x_src + 1), lflat(yy + 1, x_src + 1)],
                        [1, 1, 2, 2, 1, 1], 4, 3))

        selc = [[], []]
        for p in pos[0]:
            for ci in range(2):
                selc[ci].append(ci * Hc * Wc + (y - 1) * Wc + (x + p))
        for p in pos[1]:
            for ci in range(2):
                selc[ci].append(ci * Hc * Wc + (y + p) * Wc + (x - 1))
        if cnt[0] + cnt[1] == 2:
            taps = [taps[1], taps[0], taps[1], taps[0]]
            selc = [[s[1], s[0], s[1], s[0]] for s in selc]
        plan["selY_idx"] = np.array([t[0] for t in taps], np.int64)
        plan["selY_w"] = np.array([t[1] for t in taps], np.int64)
        plan["selY_add"] = np.array([t[2] for t in taps], np.int64)
        plan["selY_sh"] = np.array([t[3] for t in taps], np.int64)
        plan["selC_idx"] = np.array(selc, np.int64)
        plan["mid"] = mid
        # wave also depends on the selected neighbour luma taps
        si = plan["selY_idx"][plan["selY_w"] > 0]
        plan["luma_rects"].append((si // Wl, si % Wl))
        return plan


# ===================== device kernels =====================================

@functools.lru_cache()
def _intra_filters_np():
    # stacked [2, 32, 4]: fC (cubic) then fG (smoothing)
    return np.stack([np.asarray(D.intra_filter(0)),
                     np.asarray(D.intra_filter(1))]).astype(np.int32)


def _intra_filters():
    # converted per trace: a cached jnp constant would leak tracers
    return jnp.asarray(_intra_filters_np())


@functools.lru_cache()
def _mip_bank_np(size_id: int):
    t = D.tables()
    m = t[("mip_4x4", "mip_8x8", "mip_16x16")[size_id]]
    ps = (4, 4, 8)[size_id]
    return np.ascontiguousarray(m).reshape(
        m.shape[0], ps * ps, -1).astype(np.int32)


def _mip_bank(size_id: int):
    return jnp.asarray(_mip_bank_np(size_id))


def _gather_edges(pix, mid, Lidx, Tidx, fmL, fmT):
    """pix: [N] flat plane; returns filtered (L, T) [B, NREF] int32."""
    n = pix.shape[0]
    rawL = jnp.where(Lidx >= 0, pix[jnp.clip(Lidx, 0, n - 1)], mid)
    rawT = jnp.where(Tidx >= 0, pix[jnp.clip(Tidx, 0, n - 1)], mid)

    def f121(a):
        am = jnp.pad(a[:, :-1], ((0, 0), (1, 0)))
        ap = jnp.pad(a[:, 1:], ((0, 0), (0, 1)))
        return (am + 2 * a + ap + 2) >> 2

    corner = (rawL[:, PAD] + 2 * rawL[:, PAD - 1] + rawT[:, PAD] + 2) >> 2
    fLv = f121(rawL).at[:, PAD - 1].set(corner)
    fTv = f121(rawT).at[:, PAD - 1].set(corner)
    L = jnp.where(fmL, fLv, rawL)
    T = jnp.where(fmT, fTv, rawT)
    return L, T


def _res_window(res, xs, ys, w, h, W):
    base = ys * W + xs
    off = (jnp.arange(h)[:, None] * W + jnp.arange(w)[None, :])
    idx = base[:, None, None] + off
    return res[idx], idx


def _finish(pix, res, pred, xs, ys, w, h, W, mx):
    """clip(pred + residual window) and scatter back into the plane."""
    rw, idx = _res_window(res, xs, ys, w, h, W)
    out = jnp.clip(pred + rw, 0, mx)
    return pix.at[idx.reshape(-1)].set(out.astype(jnp.int32).reshape(-1))


def _simple_impl(pix, res, Lidx, Tidx, fmL, fmT, xs, ys, sel, pdpc,
                 w: int, h: int, W: int, bd: int):
    """planar / DC / vertical / horizontal (+ PDPC), per-block select."""
    mid = 1 << (bd - 1)
    mx = (1 << bd) - 1
    L, T = _gather_edges(pix, mid, Lidx, Tidx, fmL, fmT)
    t = T[:, PAD:PAD + w]                       # [B, w]
    l = L[:, PAD:PAD + h]                       # [B, h]
    logw, logh = w.bit_length() - 1, h.bit_length() - 1
    # planar
    ysr = jnp.arange(h)
    xsr = jnp.arange(w)
    pv = ((h - 1 - ysr)[None, :, None] * t[:, None, :] +
          (ysr + 1)[None, :, None] * L[:, PAD + h, None, None]) << logw
    ph_ = ((w - 1 - xsr)[None, None, :] * l[:, :, None] +
           (xsr + 1)[None, None, :] * T[:, PAD + w, None, None]) << logh
    planar = (pv + ph_ + w * h) >> (logw + logh + 1)
    # dc
    offset = (w << 1) if w == h else max(w, h)
    shift = offset.bit_length() - 1
    s = jnp.zeros(t.shape[0], jnp.int32)
    if w >= h:
        s = s + t.sum(1)
    if w <= h:
        s = s + l.sum(1)
    dc = ((s + (offset >> 1)) >> shift)[:, None, None] * \
        jnp.ones((1, h, w), jnp.int32)
    vert = jnp.broadcast_to(t[:, None, :], (t.shape[0], h, w))
    horz = jnp.broadcast_to(l[:, :, None], (t.shape[0], h, w))
    out = jnp.where(sel[:, None, None] == 0, planar,
                    jnp.where(sel[:, None, None] == 1, dc,
                              jnp.where(sel[:, None, None] == 2, vert,
                                        horz)))
    # PDPC for planar/DC/V/H (golden _pdpc_hv)
    scale = (logw + logh - 2) >> 2
    wl_row = 32 >> jnp.minimum((xsr << 1) >> scale, 31)
    wt_col = 32 >> jnp.minimum((ysr << 1) >> scale, 31)
    la = l[:, :, None]
    ta = t[:, None, :]
    is_pd = (sel <= 1)[:, None, None]
    lm1 = L[:, PAD - 1, None, None]
    tm1 = T[:, PAD - 1, None, None]
    lref = jnp.where(is_pd, la, la - lm1 + out)
    tref = jnp.where(is_pd, ta, ta - tm1 + out)
    wl = jnp.where(is_pd | (sel == 2)[:, None, None],
                   wl_row[None, None, :], 0)
    wt = jnp.where(is_pd | (sel == 3)[:, None, None],
                   wt_col[None, :, None], 0)
    pd = out + ((wl * (lref - out) + wt * (tref - out) + 32) >> 6)
    pd = jnp.clip(pd, 0, mx)
    out = jnp.where(pdpc[:, None, None] != 0, pd, out)
    return _finish(pix, res, out, xs, ys, w, h, W, mx)


def _angular_impl(pix, res, Lidx, Tidx, fmL, fmT, projL, projT, xs, ys,
                  angle, inv_angle, ref_idx, ff, pdpc, nscale,
                  w: int, h: int, W: int, bd: int, is_h: bool,
                  is_luma: bool):
    """Angular prediction (4-tap luma / 2-tap chroma) + angular PDPC."""
    mid = 1 << (bd - 1)
    mx = (1 << bd) - 1
    L0, T0 = _gather_edges(pix, mid, Lidx, Tidx, fmL, fmT)
    cat = jnp.concatenate([L0, T0], axis=1)         # [B, 2*NREF]
    L = jnp.take_along_axis(cat, projL, axis=1)
    T = jnp.take_along_axis(cat, projT, axis=1)
    mainr = L if is_h else T
    sider = T if is_h else L
    n_main = h if is_h else w
    n_cross = w if is_h else h
    js = jnp.arange(1, n_cross + 1)
    pos = (js[None, :] + ref_idx[:, None]) * angle[:, None]
    idx = (pos >> 5) + ref_idx[:, None]
    fact = pos & 31
    base = idx - (1 + ref_idx[:, None])
    p = base[:, :, None] + jnp.arange(n_main)[None, None, :]
    pn = PAD + p                                  # [B, nc, nm] >= 0

    def R(d):
        flat = (pn + d).reshape(pn.shape[0], -1)
        return jnp.take_along_axis(mainr, flat, axis=1).reshape(pn.shape)

    if is_luma:
        banks = _intra_filters()                  # [2, 32, 4]
        f = banks[ff][jnp.arange(fact.shape[0])[:, None], fact]  # [B,nc,4]
        v = (R(0) * f[..., 0, None] + R(1) * f[..., 1, None] +
             R(2) * f[..., 2, None] + R(3) * f[..., 3, None] + 32) >> 6
        v = jnp.clip(v, 0, mx)
        copy = (ff[:, None, None] == 0) & (fact[:, :, None] == 0)
        v = jnp.where(copy, R(1), v)
    else:
        v = ((32 - fact)[:, :, None] * R(1) +
             fact[:, :, None] * R(2) + 16) >> 5
    out = v.transpose(0, 2, 1) if is_h else v     # [B, h, w]

    # angular PDPC (golden _pred_angular_v/_pred_angular_h)
    wp_max = w if not is_h else h
    ks = jnp.arange(wp_max)
    sscale = 256 + inv_angle[:, None] * (ks[None, :] + 1)
    wgt = 32 >> jnp.minimum((ks << 1)[None, :] >> nscale[:, None], 31)
    wp = jnp.minimum(wp_max, 3 << nscale)
    if not is_h:
        lidx2 = PAD + jnp.arange(h)[None, :, None] + \
            (sscale >> 9)[:, None, :]             # [B, h, wp_max]
        SV = jnp.take_along_axis(
            sider, lidx2.reshape(lidx2.shape[0], -1),
            axis=1).reshape(lidx2.shape)
        dmask = (ks[None, None, :] < wp[:, None, None])
        padd = jnp.clip(out + (((SV - out) * wgt[:, None, :] + 32) >> 6),
                        0, mx)
        pd = jnp.where(dmask, padd, out)
    else:
        tidx2 = PAD + jnp.arange(w)[None, None, :] + \
            (sscale >> 9)[:, :, None]             # [B, hp_max, w]
        SV = jnp.take_along_axis(
            sider, tidx2.reshape(tidx2.shape[0], -1),
            axis=1).reshape(tidx2.shape)
        dmask = (ks[None, :, None] < wp[:, None, None])
        padd = jnp.clip(out + (((SV - out) * wgt[:, :, None] + 32) >> 6),
                        0, mx)
        pd = jnp.where(dmask, padd, out)
    out = jnp.where(pdpc[:, None, None] != 0, pd, out)
    return _finish(pix, res, out, xs, ys, w, h, W, mx)


def _mip_impl(pix, res, Lidx, Tidx, fmL, fmT, xs, ys, mode_id, transposed,
              w: int, h: int, W: int, bd: int, size_id: int):
    """Matrix intra prediction: batched matmul + linear upsampling."""
    mid = 1 << (bd - 1)
    mx = (1 << bd) - 1
    L, T = _gather_edges(pix, mid, Lidx, Tidx, fmL, fmT)
    top = T[:, PAD:PAD + w]
    left = L[:, PAD:PAD + h]
    bs = (2, 4, 4)[size_id]
    ps = (4, 4, 8)[size_id]
    in_size = 2 * bs - (1 if size_id == 2 else 0)

    def dwn(ref, n):
        bd_n = n // bs
        if bd_n == 1:
            return ref
        lg = bd_n.bit_length() - 1
        return (ref.reshape(ref.shape[0], bs, bd_n).sum(-1) +
                (1 << (lg - 1))) >> lg

    rt, rl = dwn(top, w), dwn(left, h)
    reduced = jnp.where(transposed[:, None] != 0,
                        jnp.concatenate([rl, rt], 1),
                        jnp.concatenate([rt, rl], 1))    # [B, 2*bs]
    temp0 = reduced[:, 0]
    if size_id != 2:
        off = 0
        ow0 = mid - temp0
    else:
        off = 1
        ow0 = reduced[:, 1] - temp0
    red = jnp.concatenate(
        [ow0[:, None],
         reduced[:, 1 + off:in_size + off] - temp0[:, None]], 1)
    ow = 32 - 32 * red.sum(1)
    mat = _mip_bank(size_id)[mode_id]             # [B, ps*ps, in]
    pred = (jnp.einsum("bi,bpi->bp", red, mat,
                       preferred_element_type=jnp.int32) + ow[:, None])
    pred = (pred >> 6) + temp0[:, None]
    pred = jnp.clip(pred, 0, mx).reshape(-1, ps, ps)
    grid = jnp.where(transposed[:, None, None] != 0,
                     pred.transpose(0, 2, 1), pred)      # anchors [B,ps,ps]
    up_h, up_v = w // ps, h // ps
    lg_h, lg_v = up_h.bit_length() - 1, up_v.bit_length() - 1
    # horizontal pass at anchor rows (before = left ref at those rows)
    if up_h > 1:
        lref = left[:, up_v - 1::up_v]                   # [B, ps]
        ah = jnp.concatenate([lref[:, :, None], grid], 2)  # [B, ps, ps+1]
        k = jnp.arange(1, up_h + 1)
        interp = ((up_h - k)[None, None, None, :] * ah[:, :, :-1, None] +
                  k[None, None, None, :] * ah[:, :, 1:, None] +
                  (up_h >> 1)) >> lg_h
        rows = interp.reshape(-1, ps, w)                 # [B, ps, w]
    else:
        rows = grid
    if up_v > 1:
        av = jnp.concatenate([top[:, None, :], rows], 1)  # [B, ps+1, w]
        k = jnp.arange(1, up_v + 1)
        interp = ((up_v - k)[None, None, :, None] * av[:, :-1, None, :] +
                  k[None, None, :, None] * av[:, 1:, None, :] +
                  (up_v >> 1)) >> lg_v
        out = interp.reshape(-1, h, w)
    else:
        out = rows
    return _finish(pix, res, out, xs, ys, w, h, W, mx)


_DIV_SIG_NP = np.array([0, 7, 6, 5, 5, 4, 4, 3, 3, 2, 2, 1, 1, 1, 1, 0],
                       np.int32)


def _bitlen(v, nbits=20):
    return (v[:, None] >= (1 << jnp.arange(nbits))[None, :]) \
        .sum(1).astype(jnp.int32)


def _cclm_impl(luma, chroma, resc, selY_idx, selY_w, selY_add, selY_sh,
               selC_idx, noneigh, xm1, xc, r0, rt, xs, ys,
               w: int, h: int, Wl: int, Wc: int, bd: int, variant: int):
    """CCLM: on-device linear-model derivation + collocated-luma
    downsample + prediction for both chroma components.

    variant: 0 = 4:2:0 non-collocated, 1 = 4:2:0 collocated, 2 = 4:2:2,
    3 = 4:4:4 (direct window)."""
    mid = 1 << (bd - 1)
    mx = (1 << bd) - 1
    nl = luma.shape[0]
    nc = chroma.shape[0]
    # selected neighbour luma (tap plans)
    lv = luma[jnp.clip(selY_idx, 0, nl - 1)]             # [B, 4, 6]
    vy = ((lv * selY_w).sum(-1) + selY_add) >> jnp.maximum(selY_sh, 0)
    cv = jnp.where(selC_idx >= 0,
                   chroma[jnp.clip(selC_idx, 0, nc - 1)], mid)  # [B, 2, 4]
    # two-min/two-max grouping sort network on indices (cclm_get_min_max)
    i0 = jnp.zeros(vy.shape[0], jnp.int32)
    i1 = i0 + 1
    i2 = i0 + 2
    i3 = i0 + 3

    def g(ix):
        return jnp.take_along_axis(vy, ix[:, None], 1)[:, 0]

    mn0, mn1 = i0, i2
    c = g(mn0) > g(mn1)
    mn0, mn1 = jnp.where(c, mn1, mn0), jnp.where(c, mn0, mn1)
    mx0, mx1 = i1, i3
    c = g(mx0) > g(mx1)
    mx0, mx1 = jnp.where(c, mx1, mx0), jnp.where(c, mx0, mx1)
    c = g(mn0) > g(mx1)
    mn0, mx0, mn1, mx1 = (jnp.where(c, mx0, mn0), jnp.where(c, mn0, mx0),
                          jnp.where(c, mx1, mn1), jnp.where(c, mn1, mx1))
    c = g(mn1) > g(mx0)
    mn1, mx0 = jnp.where(c, mx0, mn1), jnp.where(c, mn1, mx0)
    min_y = (g(mn0) + g(mn1) + 1) >> 1
    max_y = (g(mx0) + g(mx1) + 1) >> 1
    diff = max_y - min_y

    def gc(ix):
        return jnp.take_along_axis(cv, ix[:, None, None], 2)[:, :, 0]

    min_c = (gc(mn0) + gc(mn1) + 1) >> 1                 # [B, 2]
    max_c = (gc(mx0) + gc(mx1) + 1) >> 1
    diffc = max_c - min_c
    xsh = _bitlen(jnp.maximum(diff, 1)) - 1
    norm = ((diff << 4) >> xsh) & 15
    xsh = xsh + (norm != 0)
    ysh = (jnp.abs(diffc)[:, None, :] >=
           (1 << jnp.arange(20))[None, :, None]).sum(1)  # [B, 2]
    vsig = jnp.asarray(_DIV_SIG_NP)[norm] | 8
    add = (1 << ysh) >> 1
    a = (diffc * vsig[:, None] + add) >> ysh
    kk = 3 + xsh[:, None] - ysh
    a = jnp.where(kk < 1, jnp.sign(a) * 15, a)
    kk = jnp.maximum(1, kk)
    b = min_c - ((a * min_y[:, None]) >> kk)
    a = jnp.where((diff == 0)[:, None], 0, a)
    b = jnp.where((diff == 0)[:, None], min_c, b)
    kk = jnp.where((diff == 0)[:, None], 0, kk)
    a = jnp.where(noneigh[:, None] != 0, 0, a)
    b = jnp.where(noneigh[:, None] != 0, mid, b)
    kk = jnp.where(noneigh[:, None] != 0, 0, kk)

    # collocated luma downsample
    def lum(rr, cc):
        return luma[jnp.clip(rr * Wl + cc, 0, nl - 1)]

    R0 = r0[:, :, None]
    RT = rt[:, :, None]
    XM = xm1[:, None, :]
    XC = xc[:, None, :]
    if variant == 3:
        dsy = lum(R0, XC)
    elif variant == 2:
        dsy = (lum(R0, XM) + 2 * lum(R0, XC) + lum(R0, XC + 1) + 2) >> 2
    elif variant == 1:
        dsy = (lum(R0, XM) + lum(RT, XC) + 4 * lum(R0, XC) +
               lum(R0, XC + 1) + lum(R0 + 1, XC) + 4) >> 3
    else:
        dsy = (lum(R0, XM) + lum(R0 + 1, XM) + 2 * lum(R0, XC) +
               2 * lum(R0 + 1, XC) + lum(R0, XC + 1) +
               lum(R0 + 1, XC + 1) + 4) >> 3              # [B, h, w]
    dsy64 = dsy.astype(jnp.int64)
    pred = ((dsy64[:, None] * a[:, :, None, None].astype(jnp.int64))
            >> kk[:, :, None, None]) + b[:, :, None, None]
    pred = jnp.clip(pred, 0, mx).astype(jnp.int32)       # [B, 2, h, w]
    # residual add + scatter (both chroma components)
    HcWc = nc // 2
    out = chroma
    for ci in range(2):
        base = ci * HcWc + ys * Wc + xs
        off = jnp.arange(h)[:, None] * Wc + jnp.arange(w)[None, :]
        idx = base[:, None, None] + off
        rw = resc[idx]
        v = jnp.clip(pred[:, ci] + rw, 0, mx)
        out = out.at[idx.reshape(-1)].set(v.astype(jnp.int32).reshape(-1))
    return out


k_simple = functools.partial(
    jax.jit, static_argnames=("w", "h", "W", "bd"))(_simple_impl)
k_cclm = functools.partial(
    jax.jit,
    static_argnames=("w", "h", "Wl", "Wc", "bd", "variant"))(_cclm_impl)


@functools.partial(jax.jit,
                   static_argnames=("w", "h", "Wl", "Wc", "bd", "variant"))
def k_cclm_p(luma, chroma, resc, blob, w, h, Wl, Wc, bd, variant):
    """Packed CCLM launch: ONE int64 blob [B, 67 + 2w + 2h] holding
    selY_idx(24) selY_w(24) selY_add(4) selY_sh(4) selC_idx(8)
    noneigh xs ys | xm1(w) xc(w) | r0(h) rt(h)."""
    B = blob.shape[0]
    return _cclm_impl(
        luma, chroma, resc,
        blob[:, 0:24].reshape(B, 4, 6), blob[:, 24:48].reshape(B, 4, 6),
        blob[:, 48:52], blob[:, 52:56], blob[:, 56:64].reshape(B, 2, 4),
        blob[:, 64], blob[:, 67:67 + w], blob[:, 67 + w:67 + 2 * w],
        blob[:, 67 + 2 * w:67 + 2 * w + h],
        blob[:, 67 + 2 * w + h:67 + 2 * w + 2 * h],
        blob[:, 65], blob[:, 66], w, h, Wl, Wc, bd, variant)
k_angular = functools.partial(
    jax.jit,
    static_argnames=("w", "h", "W", "bd", "is_h", "is_luma"))(_angular_impl)
k_mip = functools.partial(
    jax.jit, static_argnames=("w", "h", "W", "bd", "size_id"))(_mip_impl)


# Packed-argument forms: the frame driver uploads ONE index pack
# [B, k, NREF] int64, ONE filter-mask pack [B, 2, NREF] int8 and ONE
# scalar pack [B, n] int32 per launch instead of 10-14 small device_puts
# (the dominant dispatch cost at 1080p: ~12 puts x thousands of wave
# buckets).  Unpacking happens inside jit, i.e. on device, for free.

@functools.partial(jax.jit, static_argnames=("w", "h", "W", "bd"))
def k_simple_p(pix, res, idxp, fmp, sc, w, h, W, bd):
    return _simple_impl(pix, res, idxp[:, 0], idxp[:, 1],
                        fmp[:, 0] != 0, fmp[:, 1] != 0,
                        sc[:, 0], sc[:, 1], sc[:, 2], sc[:, 3],
                        w, h, W, bd)


@functools.partial(jax.jit,
                   static_argnames=("w", "h", "W", "bd", "is_h", "is_luma"))
def k_angular_p(pix, res, idxp, fmp, sc, w, h, W, bd, is_h, is_luma):
    return _angular_impl(pix, res, idxp[:, 0], idxp[:, 1],
                         fmp[:, 0] != 0, fmp[:, 1] != 0,
                         idxp[:, 2], idxp[:, 3],
                         sc[:, 0], sc[:, 1], sc[:, 2], sc[:, 3], sc[:, 4],
                         sc[:, 5], sc[:, 6], sc[:, 7], w, h, W, bd,
                         is_h, is_luma)


@functools.partial(jax.jit, static_argnames=("w", "h", "W", "bd", "size_id"))
def k_mip_p(pix, res, idxp, fmp, sc, w, h, W, bd, size_id):
    return _mip_impl(pix, res, idxp[:, 0], idxp[:, 1],
                     fmp[:, 0] != 0, fmp[:, 1] != 0,
                     sc[:, 0], sc[:, 1], sc[:, 2], sc[:, 3],
                     w, h, W, bd, size_id)


# ===================== frame driver =======================================

def _pad(n):
    return 1 << max(n - 1, 0).bit_length() if n > 1 else 1


def _stackpad(arrs, B):
    a = np.stack(arrs)
    if len(arrs) < B:
        a = np.concatenate([a] + [a[:1]] * (B - len(arrs)))
    return a


def _frame_device_intra_py(recon_jobs, sps, pps, tabs, fb):
    """Python-planner path (round-3/4): golden-walk planning, per-unit
    numpy gather plans.  Kept as the fallback / A-B oracle for the C
    planner (FFVVC_INTRA_PLANNER=py forces it)."""
    jobs = []
    for rec, ctus in recon_jobs:
        nr = rec.native_recon
        if nr is None:
            return False
        jobs.append((rec, nr, ctus))

    # 1. residuals via the native record walk (residual-only mode); this
    # consumes the records' coefficient state — no fallback past here
    res_planes = [np.zeros_like(p) for p in fb.planes]
    for _rec, nr, ctus in jobs:
        nr.residual_ctus(ctus, res_planes)

    # 2. host planning: decode-order walk emitting units + waves
    H, W = fb.planes[0].shape
    shared = {"units": [],
              "wl": np.zeros((H, W), np.int32)}
    if sps.chroma_format_idc:
        shared["wc"] = np.zeros(fb.planes[1].shape, np.int32)
    for rec, nr, ctus in jobs:
        planner = IntraPlanner(rec, shared)
        for rs, rx, ry in ctus:
            planner.plan_ctu(rs, rx, ry, records_to_cus(nr, rs))

    # 3. device execution, wave by wave, bucketed launches
    bd = sps.bit_depth
    coll = int(sps.r.sps_chroma_vertical_collocated_flag)
    hs, vs = (sps.hshift[1], sps.vshift[1]) if sps.chroma_format_idc \
        else (1, 1)
    variant = 3 if (not hs and not vs) else (2 if not vs else
                                             (1 if coll else 0))
    luma = jnp.asarray(fb.planes[0].reshape(-1))
    resl = jnp.asarray(res_planes[0].reshape(-1))
    chroma = resc = None
    Wc = 0
    if sps.chroma_format_idc:
        chroma = jnp.asarray(np.stack([fb.planes[1],
                                       fb.planes[2]]).reshape(-1))
        resc = jnp.asarray(np.stack([res_planes[1],
                                     res_planes[2]]).reshape(-1))
        Wc = fb.planes[1].shape[1]

    units = shared["units"]
    waves = {}
    for u in units:
        waves.setdefault(u.wave, []).append(u)
    i32 = np.int32
    for wv in sorted(waves):
        buckets = {}
        for u in waves[wv]:
            key = (u.kind, u.w, u.h,
                   u.c_idx == 0 if u.kind != K_CCLM else variant)
            buckets.setdefault(key, []).append(u)
        for (kind, w, h, aux), us in buckets.items():
            B = _pad(len(us))
            xs = _stackpad([np.int32(u.x) for u in us], B)
            ys = _stackpad([np.int32(u.y) for u in us], B)
            if kind == K_CCLM:
                def cclm_row(u, x, y):
                    p = u.cclm
                    return np.concatenate([
                        p["selY_idx"].reshape(-1), p["selY_w"].reshape(-1),
                        p["selY_add"], p["selY_sh"],
                        p["selC_idx"].reshape(-1),
                        np.array([p["noneigh"], x, y], np.int64),
                        p["xm1"].astype(np.int64),
                        p["xc"].astype(np.int64),
                        p["r0"].astype(np.int64),
                        p["rt"].astype(np.int64)])
                blob = _stackpad(
                    [cclm_row(u, x, y)
                     for u, x, y in zip(us, xs[:len(us)], ys[:len(us)])],
                    B)
                chroma = k_cclm_p(
                    luma, chroma, resc, jnp.asarray(blob),
                    int(w), int(h), int(W), int(Wc), int(bd), int(variant))
                continue
            is_luma = aux
            pix = luma if is_luma else chroma
            rs_ = resl if is_luma else resc
            Wp = W if is_luma else Wc
            if not is_luma:
                # fold the Cb/Cr plane offset of the [2, Hc, Wc] stack into
                # ys: flat = plane_sel*Hc*Wc + y*Wc + x = (plane_sel*Hc+y)*Wc+x
                Hc = (chroma.shape[0] // 2) // Wp
                ys = ys + _stackpad(
                    [i32(u.plane_sel * Hc) for u in us], B)
            fmp = jnp.asarray(_stackpad(
                [np.stack([u.fmL, u.fmT]).astype(np.int8) for u in us], B))
            if kind == K_SIMPLE:
                idxp = jnp.asarray(_stackpad(
                    [np.stack([u.Lidx, u.Tidx]) for u in us], B))
                sc = np.zeros((B, 4), i32)
                sc[:, 0] = xs
                sc[:, 1] = ys
                sc[:len(us), 2] = [u.sel for u in us]
                sc[:len(us), 3] = [u.pdpc for u in us]
                sc[len(us):, 2:] = sc[0, 2:]   # pad rows re-run unit 0
                out = k_simple_p(pix, rs_, idxp, fmp, jnp.asarray(sc),
                                 int(w), int(h), int(Wp), int(bd))
            elif kind in (K_ANG_V, K_ANG_H):
                idxp = jnp.asarray(_stackpad(
                    [np.stack([u.Lidx, u.Tidx, u.projL, u.projT])
                     for u in us], B))
                sc = np.zeros((B, 8), i32)
                sc[:, 0] = xs
                sc[:, 1] = ys
                for j, u in enumerate(us):
                    sc[j, 2:] = (u.angle, u.inv_angle, u.ref_idx, u.ff,
                                 u.pdpc, u.nscale)
                sc[len(us):, 2:] = sc[0, 2:]
                out = k_angular_p(pix, rs_, idxp, fmp, jnp.asarray(sc),
                                  int(w), int(h), int(Wp), int(bd),
                                  kind == K_ANG_H, bool(is_luma))
            else:   # K_MIP
                if w == 4 and h == 4:
                    size_id = 0
                elif w == 4 or h == 4 or (w == 8 and h == 8):
                    size_id = 1
                else:
                    size_id = 2
                idxp = jnp.asarray(_stackpad(
                    [np.stack([u.Lidx, u.Tidx]) for u in us], B))
                sc = np.zeros((B, 4), i32)
                sc[:, 0] = xs
                sc[:, 1] = ys
                sc[:len(us), 2] = [u.mip_mode for u in us]
                sc[:len(us), 3] = [u.mip_t for u in us]
                sc[len(us):, 2:] = sc[0, 2:]   # pad rows re-run unit 0
                out = k_mip_p(pix, rs_, idxp, fmp, jnp.asarray(sc),
                              int(w), int(h), int(Wp), int(bd), size_id)
            if is_luma:
                luma = out
            else:
                chroma = out

    fb.planes[0][:] = np.asarray(luma).reshape(H, W)
    if sps.chroma_format_idc:
        cc = np.asarray(chroma).reshape(2, *fb.planes[1].shape)
        fb.planes[1][:] = cc[0]
        fb.planes[2][:] = cc[1]
    return True


# ===================== C planner driver (round 5) ==========================
# plan_intra_ctus (native/vvc_recon.c) walks the records in C, emitting one
# 26-int32 descriptor per predict unit (geometry + availability + wave);
# the per-bucket gather plans (Lidx/Tidx/filter masks/projections) are then
# built VECTORIZED over all units of a bucket — replacing the per-unit
# Python walk (round-4 planner, ~50us/unit) with array-at-once
# construction.  Descriptor field indices mirror vvc_recon.h PL_*.

(PL_KIND, PL_C_IDX, PL_X, PL_Y, PL_W, PL_H, PL_MODE, PL_ANGLE,
 PL_INV_ANGLE, PL_REF_IDX, PL_FF, PL_PDPC, PL_NSCALE, PL_LA, PL_TA,
 PL_CUL, PL_UNF_LEFT, PL_UNF_TOP, PL_REFW, PL_REFH, PL_LEFT_SIZE,
 PL_RFFFSM, PL_AUX0, PL_AUX1, PL_WAVE, PL_RSVD) = range(26)

# planning wall time of the last planned frame (seconds); the bench
# device leg prints it
last_plan_s = 0.0


def _cclm_plan_from_desc(sps, fb, x, y, w, h, avail_t, avail_l, ns_top,
                         ns_left, mode):
    """IntraPlanner._cclm_plan driven by C-emitted scalars (availability
    runs resolved natively) instead of the golden neighbour walk."""
    hs, vs = sps.hshift[1], sps.vshift[1]
    x0, y0 = x << hs, y << vs
    Hl, Wl = fb.planes[0].shape
    Hc, Wc = fb.planes[1].shape
    plan = {"noneigh": 0}
    mid = 1 << (sps.bit_depth - 1)
    if not hs and not vs:
        xm1 = x0 + np.arange(w)
        xc = x0 + np.arange(w)
        r0 = y0 + np.arange(h)
        rt = r0
    else:
        xm1 = x0 + 2 * np.arange(w) - 1
        xm1[0] = x0 - avail_l
        xc = x0 + 2 * np.arange(w)
        if not vs:
            r0 = y0 + np.arange(h)
            rt = r0
        else:
            r0 = y0 + 2 * np.arange(h)
            rt = r0 - 1
            rt[0] = y0 - avail_t
    plan["xm1"] = np.clip(xm1, 0, Wl - 1)
    plan["xc"] = np.clip(xc, 0, Wl - 1 if (not hs and not vs)
                         else max(Wl - 2, 0))
    plan["r0"] = np.clip(r0, 0, Hl - 1 if not vs else max(Hl - 2, 0))
    plan["rt"] = np.clip(rt, 0, Hl - 1)

    if not ns_top and not ns_left:
        plan["noneigh"] = 1
        plan["selY_idx"] = np.zeros((4, 6), np.int64)
        plan["selY_w"] = np.zeros((4, 6), np.int64)
        plan["selY_add"] = np.zeros(4, np.int64)
        plan["selY_sh"] = np.zeros(4, np.int64)
        plan["selC_idx"] = np.full((2, 4), -1, np.int64)
        plan["mid"] = mid
        return plan
    num_is4 = int(not avail_t or not avail_l or mode != INTRA_LT_CCLM)
    cnt, pos = [0, 0], [[], []]
    for side, ns in enumerate((ns_top, ns_left)):
        start = ns >> (2 + num_is4)
        step = max(1, ns >> (1 + num_is4))
        cnt[side] = min(ns, (1 + num_is4) << 1)
        pos[side] = [start + c * step for c in range(cnt[side])]

    taps = []
    coll = sps.r.sps_chroma_vertical_collocated_flag
    b_ctu_boundary = not (y0 & ((1 << sps.ctb_log2_size_y) - 1))

    def lflat(yy, xx):
        return yy * Wl + xx

    if not hs and not vs:
        for p in pos[0]:
            taps.append(([lflat(y0 - avail_t, x0 + p)] + [0] * 5,
                         [1, 0, 0, 0, 0, 0], 0, 0))
        for p in pos[1]:
            taps.append(([lflat(y0 + p, x0 - avail_l)] + [0] * 5,
                         [1, 0, 0, 0, 0, 0], 0, 0))
    else:
        for p in pos[0]:        # top row(s)
            xx = p << hs
            xl = x0 + xx - 1 if (xx or avail_l) else x0 + xx
            if vs and not b_ctu_boundary:
                yb = y0 - 2
                if coll:
                    taps.append((
                        [lflat(yb - 1, x0 + xx), lflat(yb, xl),
                         lflat(yb, x0 + xx), lflat(yb, x0 + xx + 1),
                         lflat(yb + 1, x0 + xx), 0],
                        [1, 1, 4, 1, 1, 0], 4, 3))
                else:
                    taps.append((
                        [lflat(yb, xl), lflat(yb + 1, xl),
                         lflat(yb, x0 + xx), lflat(yb + 1, x0 + xx),
                         lflat(yb, x0 + xx + 1),
                         lflat(yb + 1, x0 + xx + 1)],
                        [1, 1, 2, 2, 1, 1], 4, 3))
            else:
                yb = y0 - 1
                taps.append((
                    [lflat(yb, xl), lflat(yb, x0 + xx),
                     lflat(yb, x0 + xx + 1), 0, 0, 0],
                    [1, 2, 1, 0, 0, 0], 2, 2))
        x_src = x0 - (1 + hs) * avail_l
        x_l = x_src - avail_l
        for p in pos[1]:        # left column
            yy = y0 + (p << vs)
            if not vs:
                taps.append((
                    [lflat(yy, x_l), lflat(yy, x_src),
                     lflat(yy, x_src + 1), 0, 0, 0],
                    [1, 2, 1, 0, 0, 0], 2, 2))
            elif coll:
                ty = yy - 1 if ((p << vs) or avail_t) else yy
                taps.append((
                    [lflat(yy, x_l), lflat(ty, x_src),
                     lflat(yy, x_src), lflat(yy, x_src + 1),
                     lflat(yy + 1, x_src), 0],
                    [1, 1, 4, 1, 1, 0], 4, 3))
            else:
                taps.append((
                    [lflat(yy, x_l), lflat(yy + 1, x_l),
                     lflat(yy, x_src), lflat(yy + 1, x_src),
                     lflat(yy, x_src + 1), lflat(yy + 1, x_src + 1)],
                    [1, 1, 2, 2, 1, 1], 4, 3))

    selc = [[], []]
    for p in pos[0]:
        for ci in range(2):
            selc[ci].append(ci * Hc * Wc + (y - 1) * Wc + (x + p))
    for p in pos[1]:
        for ci in range(2):
            selc[ci].append(ci * Hc * Wc + (y + p) * Wc + (x - 1))
    if cnt[0] + cnt[1] == 2:
        taps = [taps[1], taps[0], taps[1], taps[0]]
        selc = [[s[1], s[0], s[1], s[0]] for s in selc]
    plan["selY_idx"] = np.array([t[0] for t in taps], np.int64)
    plan["selY_w"] = np.array([t[1] for t in taps], np.int64)
    plan["selY_add"] = np.array([t[2] for t in taps], np.int64)
    plan["selY_sh"] = np.array([t[3] for t in taps], np.int64)
    plan["selC_idx"] = np.array(selc, np.int64)
    plan["mid"] = mid
    return plan


def frame_device_intra(recon_jobs, sps, pps, tabs, fb):
    """Device-resident intra reconstruction of an all-intra frame.

    Planning runs in C (plan_intra_ctus record walk emitting descriptor
    rows + waves) and the per-bucket gather plans build vectorized —
    array-at-once over every unit of a bucket (VERDICT r4 item 2; the
    round-4 per-unit Python planner remains as _frame_device_intra_py,
    forced with FFVVC_INTRA_PLANNER=py).  Returns True when the frame
    was reconstructed (fb.planes updated), False when ineligible
    (caller falls back to the native C walk; no state touched)."""
    import os as _os
    import time as _time
    if _os.environ.get("FFVVC_INTRA_PLANNER") == "py":
        return _frame_device_intra_py(recon_jobs, sps, pps, tabs, fb)
    jobs = []
    for rec, ctus in recon_jobs:
        nr = rec.native_recon
        if nr is None or not hasattr(nr.lib, "plan_intra_ctus"):
            return False
        jobs.append((rec, nr, ctus))
    global last_plan_s
    H, W = fb.planes[0].shape
    chroma_on = bool(sps.chroma_format_idc)
    Hc, Wc = fb.planes[1].shape if chroma_on else (0, 0)
    wl = np.zeros((H, W), np.int32)
    wc = np.zeros((Hc, Wc), np.int32) if chroma_on else None

    # --- 1. C plan walk (consumes no record state: clean fallback) -------
    t0 = _time.perf_counter()
    cap = max(8192, (pps.width // 2) * (pps.height // 2) // 8)
    while True:
        wl[:] = 0
        if wc is not None:
            wc[:] = 0
        buf = np.empty((cap, 26), np.int32)
        off = 0
        grown = False
        try:
            for rec, nr, ctus in jobs:
                off += nr.plan_ctus(ctus, buf[off:], wl, wc)
        except ValueError as e:
            if "err=5" in str(e):      # descriptor buffer overflow
                cap *= 4
                grown = True
            else:
                return False           # unsupported CU: native C recon
        if not grown:
            break
    D = buf[:off]
    t_walk = _time.perf_counter() - t0
    if not off:
        return False

    # --- 2. vectorized bucket construction, ordered by wave --------------
    t1 = _time.perf_counter()
    bd = sps.bit_depth
    coll = int(sps.r.sps_chroma_vertical_collocated_flag)
    hs, vs = (sps.hshift[1], sps.vshift[1]) if chroma_on else (1, 1)
    variant = 3 if (not hs and not vs) else (2 if not vs else
                                             (1 if coll else 0))
    i32 = np.int32
    launches = []     # (kernel_id, payload tuple), wave-ordered
    # ONE sort up front: buckets are contiguous runs of equal
    # (wave, kind, w, h, is-chroma); wave stays the most significant key
    # so launch order respects dependencies.  Per-unit plans never
    # materialize on host — the kernels build the [B, NREF] gather index
    # arrays in-jit from the 21-scalar geo rows (_edge_idx_jnp).
    isc0 = (D[:, PL_C_IDX] > 0).astype(i32)
    order = np.lexsort((isc0, D[:, PL_H], D[:, PL_W], D[:, PL_KIND],
                        D[:, PL_WAVE]))
    Ds = D[order].astype(i32)
    isc = isc0[order]
    N = Ds.shape[0]
    keys = np.stack([Ds[:, PL_WAVE], Ds[:, PL_KIND], Ds[:, PL_W],
                     Ds[:, PL_H], isc], axis=1)
    bnd = np.flatnonzero(np.any(keys[1:] != keys[:-1], axis=1)) + 1
    starts = np.concatenate([[0], bnd])
    ends = np.concatenate([bnd, [N]])
    kind_all = Ds[:, PL_KIND]
    # geo pack [N, 21] (G_* columns; pad rows re-run unit 0)
    geo_all = np.zeros((N, 21), i32)
    geo_all[:, G_X] = Ds[:, PL_X]
    geo_all[:, G_Y] = Ds[:, PL_Y]
    geo_all[:, G_YF] = Ds[:, PL_Y] + np.where(
        isc > 0, (Ds[:, PL_C_IDX] - 1) * Hc, 0)
    geo_all[:, G_BASE] = np.where(
        isc > 0, (Ds[:, PL_C_IDX] - 1) * (Hc * Wc), 0)
    geo_all[:, G_LA] = Ds[:, PL_LA]
    geo_all[:, G_TA] = Ds[:, PL_TA]
    geo_all[:, G_CUL] = Ds[:, PL_CUL]
    geo_all[:, G_REF] = Ds[:, PL_REF_IDX]
    geo_all[:, G_UNFL] = Ds[:, PL_UNF_LEFT]
    geo_all[:, G_UNFT] = Ds[:, PL_UNF_TOP]
    geo_all[:, G_REFW] = Ds[:, PL_REFW]
    geo_all[:, G_REFH] = Ds[:, PL_REFH]
    geo_all[:, G_LSIZE] = Ds[:, PL_LEFT_SIZE]
    geo_all[:, G_RFFFSM] = Ds[:, PL_RFFFSM]
    geo_all[:, G_ANGLE] = Ds[:, PL_ANGLE]
    geo_all[:, G_INV] = Ds[:, PL_INV_ANGLE]
    geo_all[:, G_FF] = Ds[:, PL_FF]
    geo_all[:, G_PDPC] = Ds[:, PL_PDPC]
    geo_all[:, G_NSCALE] = Ds[:, PL_NSCALE]
    m = kind_all == K_SIMPLE
    if m.any():
        sel_lut = np.zeros(67, i32)
        sel_lut[INTRA_PLANAR] = 0
        sel_lut[INTRA_DC] = 1
        sel_lut[INTRA_VERT] = 2
        sel_lut[INTRA_HORZ] = 3
        geo_all[m, G_A0] = sel_lut[Ds[m, PL_MODE]]
    m = kind_all == K_MIP
    if m.any():
        geo_all[m, G_A0] = Ds[m, PL_AUX0]
        geo_all[m, G_A1] = Ds[m, PL_AUX1]
    # vectorized pow2 padding for every bucket at once: one big gather
    # (pad rows re-run unit 0 of their bucket); batches no smaller than
    # MIN_BATCH share their compiled kernels (mc_device.MIN_BATCH)
    b0s = (ends - starts).astype(np.int64)
    bps = np.maximum(
        1 << np.ceil(np.log2(np.maximum(b0s, 1))).astype(np.int64),
        MIN_BATCH)
    offs_pad = np.concatenate([[0], np.cumsum(bps)])
    rows_cat = np.repeat(starts, bps)
    fill = np.arange(int(b0s.sum())) - np.repeat(np.cumsum(b0s) - b0s,
                                                 b0s)
    pos = np.repeat(offs_pad[:-1], b0s) + fill
    rows_cat[pos] = np.repeat(starts, b0s) + fill
    geo_pad = np.ascontiguousarray(geo_all[rows_cat])
    for bi, (s0, s1) in enumerate(zip(starts, ends)):
        kind = int(kind_all[s0])
        w = int(Ds[s0, PL_W])
        h = int(Ds[s0, PL_H])
        is_luma = not isc[s0]
        B0 = int(s1 - s0)
        B = int(bps[bi])
        o0 = int(offs_pad[bi])
        if kind == K_CCLM:
            crows = []
            for j in range(s0, s1):
                d = Ds[j]
                pl = _cclm_plan_from_desc(
                    sps, fb, int(d[PL_X]), int(d[PL_Y]), w, h,
                    int(d[PL_TA]), int(d[PL_LA]),
                    int(d[PL_AUX0]), int(d[PL_AUX1]), int(d[PL_MODE]))
                crows.append(np.concatenate([
                    pl["selY_idx"].reshape(-1), pl["selY_w"].reshape(-1),
                    pl["selY_add"], pl["selY_sh"],
                    pl["selC_idx"].reshape(-1),
                    np.array([pl["noneigh"], d[PL_X], d[PL_Y]], np.int64),
                    pl["xm1"].astype(np.int64),
                    pl["xc"].astype(np.int64),
                    pl["r0"].astype(np.int64),
                    pl["rt"].astype(np.int64)]))
            blob = np.stack(crows)
            if B != B0:
                blob = np.concatenate(
                    [blob, np.repeat(blob[:1], B - B0, axis=0)])
            launches.append(("cclm", (blob, w, h)))
            continue
        geo = geo_pad[o0:o0 + B]
        Wp = W if is_luma else Wc
        if kind in (K_ANG_V, K_ANG_H):
            launches.append(("ang", (geo, w, h, Wp, kind == K_ANG_H,
                                     is_luma)))
        elif kind == K_SIMPLE:
            launches.append(("simple", (geo, w, h, Wp, is_luma)))
        else:
            if w == 4 and h == 4:
                size_id = 0
            elif w == 4 or h == 4 or (w == 8 and h == 8):
                size_id = 1
            else:
                size_id = 2
            launches.append(("mip", (geo, w, h, Wp, size_id, is_luma)))
    last_plan_s = t_walk + (_time.perf_counter() - t1)
    if _os.environ.get("FFVVC_PLAN_DEBUG"):
        print(f"plan: walk={t_walk*1e3:.2f}ms "
              f"build={(_time.perf_counter() - t1)*1e3:.2f}ms "
              f"units={off} launches={len(launches)}", flush=True)
    if _os.environ.get("FFVVC_INTRA_PLAN_ONLY"):
        # measurement mode: plan consumed no record state; the caller
        # reconstructs on the host as if ineligible
        return False

    # --- 3. residuals via the native record walk (consumes coefficient
    # state — no fallback past here) -------------------------------------
    res_planes = [np.zeros_like(p) for p in fb.planes]
    for _rec, nr, ctus in jobs:
        nr.residual_ctus(ctus, res_planes)

    # --- 4. device execution -------------------------------------------
    luma = jnp.asarray(fb.planes[0].reshape(-1))
    resl = jnp.asarray(res_planes[0].reshape(-1))
    chroma = resc = None
    if chroma_on:
        chroma = jnp.asarray(np.stack([fb.planes[1],
                                       fb.planes[2]]).reshape(-1))
        resc = jnp.asarray(np.stack([res_planes[1],
                                     res_planes[2]]).reshape(-1))
    for tag, payload in launches:
        if tag == "cclm":
            blob, w, h = payload
            chroma = k_cclm_p(luma, chroma, resc, jnp.asarray(blob),
                              int(w), int(h), int(W), int(Wc), int(bd),
                              int(variant))
            continue
        if tag == "simple":
            geo, w, h, Wp, is_luma = payload
            pix = luma if is_luma else chroma
            rs_ = resl if is_luma else resc
            out = k_simple_g(pix, rs_, jnp.asarray(geo),
                             int(w), int(h), int(Wp), int(bd))
        elif tag == "ang":
            geo, w, h, Wp, is_h, is_luma = payload
            pix = luma if is_luma else chroma
            rs_ = resl if is_luma else resc
            out = k_angular_g(pix, rs_, jnp.asarray(geo),
                              int(w), int(h), int(Wp), int(bd),
                              bool(is_h), bool(is_luma))
        else:   # mip
            geo, w, h, Wp, size_id, is_luma = payload
            pix = luma if is_luma else chroma
            rs_ = resl if is_luma else resc
            out = k_mip_g(pix, rs_, jnp.asarray(geo), int(w), int(h),
                          int(Wp), int(bd), size_id)
        if is_luma:
            luma = out
        else:
            chroma = out

    fb.planes[0][:] = np.asarray(luma).reshape(H, W)
    if chroma_on:
        cc = np.asarray(chroma).reshape(2, Hc, Wc)
        fb.planes[1][:] = cc[0]
        fb.planes[2][:] = cc[1]
    return True


# ---- on-device gather-plan construction (round 5, stage 2) ---------------
# The [B, NREF] Lidx/Tidx/filter-mask/projection arrays build INSIDE jit
# from ~20 scalars per unit (the array form of IntraPlanner._edge_plan /
# _proj_plan) — the host never materializes per-unit index arrays.

(G_X, G_Y, G_YF, G_BASE, G_LA, G_TA, G_CUL, G_REF, G_UNFL, G_UNFT,
 G_REFW, G_REFH, G_LSIZE, G_RFFFSM, G_ANGLE, G_INV, G_FF, G_PDPC,
 G_NSCALE, G_A0, G_A1) = range(21)


def _edge_idx_jnp(g, W: int):
    """geo [B, 21] int32 -> (Lidx, Tidx [B, NREF] int32, fmL, fmT bool)."""
    ii = (jnp.arange(NREF, dtype=jnp.int32) - PAD)[None, :]
    x = g[:, G_X, None]
    y = g[:, G_Y, None]
    la = g[:, G_LA, None]
    ta = g[:, G_TA, None]
    cul = g[:, G_CUL, None]
    rl = -1 - g[:, G_REF, None]
    unf_l = g[:, G_UNFL, None]
    unf_t = g[:, G_UNFT, None]
    b = g[:, G_BASE, None]
    corner_common = jnp.where(
        la > 0, b + y * W + (x + rl),
        jnp.where(ta > 0, b + (y + rl) * W + x, -1))
    cornerL = jnp.where(cul != 0, b + (y + ii) * W + (x + rl),
                        corner_common)
    cornerT = jnp.where(cul != 0, b + (y + rl) * W + (x + ii),
                        corner_common)
    corner_m1_L = jnp.where(cul != 0, b + (y - 1) * W + (x + rl),
                            corner_common)
    corner_m1_T = jnp.where(cul != 0, b + (y + rl) * W + (x - 1),
                            corner_common)
    ip = jnp.minimum(jnp.maximum(ii, 0), jnp.maximum(la - 1, 0))
    Lmain = jnp.where(la > 0, b + (y + ip) * W + (x + rl), corner_m1_L)
    tp = jnp.minimum(jnp.maximum(ii, 0), jnp.maximum(ta - 1, 0))
    Tmain = jnp.where(ta > 0, b + (y + rl) * W + (x + tp), corner_m1_T)
    Lidx = jnp.where(ii >= unf_l, -1,
                     jnp.where(ii >= 0, Lmain,
                               jnp.where(ii >= rl, cornerL, -1)))
    Tidx = jnp.where(ii >= unf_t, -1,
                     jnp.where(ii >= 0, Tmain,
                               jnp.where(ii >= rl, cornerT, -1)))
    fsm = g[:, G_RFFFSM, None] != 0
    ul = (g[:, G_LSIZE, None] == unf_l).astype(jnp.int32)
    fmL = fsm & ((ii == -1) | ((ii >= 0) & (ii < unf_l - ul)))
    fmT = fsm & ((ii == -1) | ((ii >= 0) & (ii < unf_t - ul)))
    return Lidx, Tidx, fmL, fmT


def _proj_idx_jnp(g, w: int, h: int, is_v: bool):
    """geo [B, 21] -> (projL, projT [B, NREF] int32)."""
    B = g.shape[0]
    ii = (jnp.arange(NREF, dtype=jnp.int32) - PAD)[None, :]
    angle = g[:, G_ANGLE, None]
    inv_angle = g[:, G_INV, None]
    ref_idx = g[:, G_REF, None]
    refw = g[:, G_REFW, None]
    refh = g[:, G_REFH, None]
    projL = jnp.broadcast_to(jnp.arange(NREF, dtype=jnp.int32)[None, :],
                             (B, NREF))
    projT = projL + NREF
    xx = ii + ref_idx + 1
    if is_v:
        idxs = -1 - ref_idx + jnp.minimum((xx * inv_angle + 256) >> 9, h)
        neg = (angle < 0) & (xx >= -h) & (xx < 0)
        hi = refw + max(1, w // h) * ref_idx + 2
        pos = (angle >= 0) & (ii >= refw) & (ii < hi)
        projT = jnp.where(neg, PAD + idxs,
                          jnp.where(pos, NREF + PAD + refw - 1, projT))
    else:
        idxs = -1 - ref_idx + jnp.minimum((xx * inv_angle + 256) >> 9, w)
        neg = (angle < 0) & (xx >= -w) & (xx < 0)
        hi = refh + max(1, h // w) * ref_idx + 2
        pos = (angle >= 0) & (ii >= refh) & (ii < hi)
        projL = jnp.where(neg, NREF + PAD + idxs,
                          jnp.where(pos, PAD + refh - 1, projL))
    return projL, projT


@functools.partial(jax.jit, static_argnames=("w", "h", "W", "bd"))
def k_simple_g(pix, res, geo, w, h, W, bd):
    Lidx, Tidx, fmL, fmT = _edge_idx_jnp(geo, W)
    return _simple_impl(pix, res, Lidx, Tidx, fmL, fmT,
                        geo[:, G_X], geo[:, G_YF], geo[:, G_A0],
                        geo[:, G_PDPC], w, h, W, bd)


@functools.partial(jax.jit,
                   static_argnames=("w", "h", "W", "bd", "is_h", "is_luma"))
def k_angular_g(pix, res, geo, w, h, W, bd, is_h, is_luma):
    Lidx, Tidx, fmL, fmT = _edge_idx_jnp(geo, W)
    projL, projT = _proj_idx_jnp(geo, w, h, not is_h)
    return _angular_impl(pix, res, Lidx, Tidx, fmL, fmT, projL, projT,
                         geo[:, G_X], geo[:, G_YF], geo[:, G_ANGLE],
                         geo[:, G_INV], geo[:, G_REF], geo[:, G_FF],
                         geo[:, G_PDPC], geo[:, G_NSCALE],
                         w, h, W, bd, is_h, is_luma)


@functools.partial(jax.jit, static_argnames=("w", "h", "W", "bd", "size_id"))
def k_mip_g(pix, res, geo, w, h, W, bd, size_id):
    Lidx, Tidx, fmL, fmT = _edge_idx_jnp(geo, W)
    return _mip_impl(pix, res, Lidx, Tidx, fmL, fmT,
                     geo[:, G_X], geo[:, G_YF], geo[:, G_A0],
                     geo[:, G_A1], w, h, W, bd, size_id)
