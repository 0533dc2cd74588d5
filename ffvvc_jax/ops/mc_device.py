"""Device inter MC: batched 8-tap (luma) / 4-tap (chroma) fractional-sample
interpolation over same-size block batches.

Batched formulation of the reference's hottest kernels
(/root/reference/libavcodec/x86/h26x/h2656_inter.asm wrapped at
x86/vvc/vvcdsp_init.c:34-171): instead of one call per block, all MC jobs of
one (w, h, is_luma, frac-class) bucket are a single batched XLA launch —
clamped gather of the (h+taps-1, w+taps-1) windows, then separable taps as
two small contractions.  Integer math only (int32), bit-exact vs the host
golden (inter.py _mc_put), pinned by tests/test_device_mc.py.

Decoder integration covers EVERY block shape of the reference's SIMD
(vvcdsp_init.c grid): regular blocks (incl. weighted pred / BCW /
LMCS-forward / wraparound), GPM blends, affine (+PROF gradient
refinement) and SbTMVP subblock grids — subblock MVs expand from the
frame's mvf/cp_mv tab grids — and DMVR/BDOF, restructured into
frame-batched phases: phase A runs every DMVR subblock's bilinear
prefetch + 25-point SAD refine as batched launches (ops/inter_device kernels), then the refined MVs feed
box-clamped puts, batched per-4x4 BDOF solves and the TMVP col-grid
writeback (the reference interleaves these per CTU inside the inter
task, vvc_inter.c:642-760; hoisting the refine to a frame phase is what
makes it batchable).
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp


@functools.lru_cache()
def _filter_banks():
    from . import data as D
    t = D.tables()
    return (t["luma_filters"].astype(np.int32),
            t["chroma_filters"].astype(np.int32))


# smallest launch batch: batches pad to a power of two no smaller than this
# (a 1080p RA frame's buckets then share ~3x fewer shapes; each new shape
# costs an XLA:GPU compile of ~0.5 s, the padded rows next to nothing)
MIN_BATCH = 32


def _batch_size(n):
    return max(MIN_BATCH, 1 << max(n - 1, 0).bit_length())


def _pad_batch(a, n=None):
    """Pad the leading (batch) axis to n, by default _batch_size, repeating
    entry 0: every launch shape then recurs across blocks, rows and frames,
    which bounds the number of XLA compilations.  Pad rows are computed and
    dropped."""
    a = np.stack(a) if isinstance(a, list) else np.asarray(a)
    B0 = a.shape[0]
    B = n if n is not None else _batch_size(B0)
    if B != B0:
        a = np.concatenate([a, np.repeat(a[:1], B - B0, axis=0)])
    return a


def _mc_put_math(ref, xs, ys, hf, vf, box, w: int, h: int, is_luma: bool,
                 bd: int, fclass: int, wrap: int = 0,
                 boxed: bool = False):
    """Batched put: ref [H, W] int32; xs/ys [B] block origins (integer-pel,
    already including mv>>4); hf/vf [B, taps] filter rows.  fclass selects
    the put variant (0: copy, 1: h only, 2: v only, 3: hv) — the
    put[..][!!my][!!mx] grid of vvcdsp.h:49.  wrap: horizontal wraparound
    offset (spec 8.5.6.3.2 ClipH; 0 = clamp).  boxed: clamp sample
    coordinates into per-block inclusive boxes box [B, 4] = (x0, x1, y0,
    y1) — the DMVR prefetch-window emulation (native fetch()).  Returns
    [B, h, w] int32 in the 14-bit intermediate domain."""
    H, W = ref.shape
    taps = 8 if is_luma else 4
    eb = 3 if is_luma else 1

    def gather(x0s, y0s, gw, gh):
        gx = x0s[:, None] + jnp.arange(gw)[None, :]
        if wrap:
            gx = jnp.where(gx < 0, gx + wrap,
                           jnp.where(gx > W - 1, gx - wrap, gx))
        gy = y0s[:, None] + jnp.arange(gh)[None, :]
        if boxed:
            gx = jnp.clip(gx, box[:, 0:1], box[:, 1:2])
            gy = jnp.clip(gy, box[:, 2:3], box[:, 3:4])
        gx = jnp.clip(gx, 0, W - 1)
        gy = jnp.clip(gy, 0, H - 1)
        return ref[gy[:, :, None], gx[:, None, :]]   # [B, gh, gw]

    if fclass == 0:
        return gather(xs, ys, w, h) << (14 - bd)
    if fclass == 1:
        src = gather(xs - eb, ys, w + taps - 1, h)
        acc = jnp.zeros((xs.shape[0], h, w), jnp.int32)
        for k in range(taps):
            acc = acc + src[:, :, k:k + w] * hf[:, k, None, None]
        return acc >> (bd - 8)
    if fclass == 2:
        src = gather(xs, ys - eb, w, h + taps - 1)
        acc = jnp.zeros((xs.shape[0], h, w), jnp.int32)
        for k in range(taps):
            acc = acc + src[:, k:k + h, :] * vf[:, k, None, None]
        return acc >> (bd - 8)
    src = gather(xs - eb, ys - eb, w + taps - 1, h + taps - 1)
    tmp = jnp.zeros((xs.shape[0], h + taps - 1, w), jnp.int32)
    for k in range(taps):
        tmp = tmp + src[:, :, k:k + w] * hf[:, k, None, None]
    tmp = tmp >> (bd - 8)
    acc = jnp.zeros((xs.shape[0], h, w), jnp.int32)
    for k in range(taps):
        acc = acc + tmp[:, k:k + h, :] * vf[:, k, None, None]
    return acc >> 6


_mc_put_batch = functools.partial(
    jax.jit, static_argnames=("w", "h", "is_luma", "bd", "fclass",
                              "wrap", "boxed"))(_mc_put_math)

# mesh-sharded puts: the batch axis of a bucket partitions over the
# "tile" mesh axis (reference planes replicated — each device gathers
# its own blocks), the sharded outputs concatenate back.  The collective
# form of the reference's per-CTU inter tasks running on every worker
# (vvc_thread.c:432-450).
_SHARD_PUT_CACHE = {}
sharded_puts = 0      # diagnostic counter (tests assert engagement)


def _sharded_put_fn(mesh, statics):
    key = (id(mesh),) + statics
    fn = _SHARD_PUT_CACHE.get(key)
    if fn is None:
        from jax.sharding import PartitionSpec as P
        w, h, is_luma, bd, fclass, wrap, boxed = statics

        def local(ref, xs, ys, hf, vf, box):
            return _mc_put_math(ref, xs, ys, hf, vf, box, w, h, is_luma,
                                bd, fclass, wrap, boxed)

        fn = jax.jit(jax.shard_map(
            local, mesh=mesh,
            in_specs=(P(), P("tile"), P("tile"), P("tile", None),
                      P("tile", None), P("tile", None)),
            out_specs=P("tile", None, None)))
        _SHARD_PUT_CACHE[key] = fn
    return fn


@functools.partial(jax.jit, static_argnames=("bd",))
def _mc_avg_batch(s0, s1, bd: int):
    """Bi-prediction average: [B, h, w] 14-bit pair -> pixels."""
    shift = max(3, 15 - bd)
    off = 1 << (shift - 1)
    return jnp.clip((s0 + s1 + off) >> shift, 0, (1 << bd) - 1)


@functools.partial(jax.jit, static_argnames=("bd",))
def _mc_uni_batch(val, bd: int):
    shift = 14 - bd
    off = 1 << (shift - 1)
    return jnp.clip((val + off) >> shift, 0, (1 << bd) - 1)


@functools.partial(jax.jit, static_argnames=("bd",))
def _prof_apply_batch(val, ring, dmx, dmy, bd: int):
    """PROF gradient refinement of affine 4x4 subblocks: val [B, 4, 4]
    (14-bit put output), ring [B, 6, 6] (integer samples << (14-bd),
    fclass-0 put of the 6x6 window), dmx/dmy [B, 4, 4].  Mirrors native
    prof_block: the ring's interior is replaced by the put values before
    the gradients read it."""
    padded = ring.at[:, 1:5, 1:5].set(val)
    gh = (padded[:, 1:5, 2:6] >> 6) - (padded[:, 1:5, 0:4] >> 6)
    gv = (padded[:, 2:6, 1:5] >> 6) - (padded[:, 0:4, 1:5] >> 6)
    limit = 1 << max(13, bd + 1)
    di = jnp.clip(gh * dmx + gv * dmy, -limit, limit - 1)
    return padded[:, 1:5, 1:5] + di


def _affine_diff_mvs(cp, num_cp, w, h):
    """Per-4x4 PROF diff-MV grids from the stored control-point MVs —
    the numpy twin of native affine_sb_params + affine_diff_mvs
    (mvs.py _init_subblock_params / _derive_subblock_diff_mvs)."""
    D = 7                                   # MAX_CU_DEPTH
    lw, lh = w.bit_length() - 1, h.bit_length() - 1
    cp = np.asarray(cp, np.int64)
    d_hor_x = (cp[1, 0] - cp[0, 0]) << (D - lw)
    d_ver_x = (cp[1, 1] - cp[0, 1]) << (D - lw)
    if num_cp == 3:
        d_hor_y = (cp[2, 0] - cp[0, 0]) << (D - lh)
        d_ver_y = (cp[2, 1] - cp[0, 1]) << (D - lh)
    else:
        d_hor_y = -d_ver_x
        d_ver_y = d_hor_x
    lim = 1 << 5
    xs = np.arange(4, dtype=np.int64)[None, :]
    ys = np.arange(4, dtype=np.int64)[:, None]
    d0 = xs * (d_hor_x << 2) + ys * (d_hor_y << 2) - \
        6 * (d_hor_x + d_hor_y)
    d1 = xs * (d_ver_x << 2) + ys * (d_ver_y << 2) - \
        6 * (d_ver_x + d_ver_y)
    d0 = (d0 + 128 - (d0 >= 0)) >> 8        # round_mv(d, 0, 8)
    d1 = (d1 + 128 - (d1 >= 0)) >> 8
    return (np.clip(d0, -lim + 1, lim - 1).astype(np.int32),
            np.clip(d1, -lim + 1, lim - 1).astype(np.int32))


@functools.partial(jax.jit,
                   static_argnames=("pw", "ph", "bd", "mclass", "wrap"))
def _dmvr_bilin_batch(ref, xs, ys, fx, fy, pw: int, ph: int, bd: int,
                      mclass: int, wrap: int):
    """Batched DMVR bilinear prefetch to the 10-bit domain: xs/ys [B]
    window origins (x0 + (mv>>4) - 2), fx/fy [B, 2] 2-tap rows per the
    fractional phases.  mclass like fclass (0 copy, 1 h, 2 v, 3 hv).
    Mirrors native dmvr_bilinear."""
    H, W = ref.shape

    def gather(gw, gh):
        gx = xs[:, None] + jnp.arange(gw)[None, :]
        if wrap:
            gx = jnp.where(gx < 0, gx + wrap,
                           jnp.where(gx > W - 1, gx - wrap, gx))
        gx = jnp.clip(gx, 0, W - 1)
        gy = jnp.clip(ys[:, None] + jnp.arange(gh)[None, :], 0, H - 1)
        return ref[gy[:, :, None], gx[:, None, :]]

    if mclass == 0:
        v = gather(pw, ph)
        if bd > 10:
            return (v + (1 << (bd - 11))) >> (bd - 10)
        return v << (10 - bd)
    shift1 = bd - 6
    off1 = 1 << (shift1 - 1)
    f0x, f1x = fx[:, 0, None, None], fx[:, 1, None, None]
    f0y, f1y = fy[:, 0, None, None], fy[:, 1, None, None]
    if mclass == 1:
        src = gather(pw + 1, ph)
        return (f0x * src[:, :, :pw] + f1x * src[:, :, 1:] + off1) >> shift1
    if mclass == 2:
        src = gather(pw, ph + 1)
        return (f0y * src[:, :ph] + f1y * src[:, 1:] + off1) >> shift1
    src = gather(pw + 1, ph + 1)
    tmp = (f0x * src[:, :, :pw] + f1x * src[:, :, 1:] + off1) >> shift1
    return (f0y * tmp[:, :ph] + f1y * tmp[:, 1:] + 8) >> 4


@functools.partial(jax.jit, static_argnames=("w", "h", "bd"))
def _bdof_full_batch(s0, s1, r0, r1, w: int, h: int, bd: int):
    """BDOF finals: puts s0/s1 [B, h, w] placed into their integer rings
    r0/r1 [B, h+2, w+2] (bdof_fetch layout), then the per-4x4 vx/vy
    solve + apply (ops/inter_device._bdof)."""
    from .inter_device import _bdof
    return _bdof(r0.at[:, 1:1 + h, 1:1 + w].set(s0),
                 r1.at[:, 1:1 + h, 1:1 + w].set(s1), w, h, bd)


def _dmvr_box(x_sb, y_sb, w, h, is_luma, pw, ph):
    """Native dmvr_box: the inclusive prefetch-window clamp bounds."""
    eb, ea = (3, 4) if is_luma else (1, 2)
    sx = min(max(x_sb - eb, 0), pw - 1)
    sy = min(max(y_sb - eb, 0), ph - 1)
    wdt = max(min(pw, x_sb + w + ea) - sx, 1)
    hgt = max(min(ph, y_sb + h + ea) - sy, 1)
    return (sx, sx + wdt - 1, sy, sy + hgt - 1)


@functools.lru_cache()
def _dmvr_filters():
    from . import data as D
    return np.asarray(D.tables()["luma_dmvr_filters"], np.int32)


@functools.partial(jax.jit, static_argnames=("bd",))
def _mc_gpm_batch(s0, s1, wgt, bd: int):
    """GPM two-hypothesis blend: wgt [B, h, w] in 0..8 (host-sliced from
    the partition weight tables); mirrors native pred_gpm_blk."""
    shift = max(5, 17 - bd)
    off = 1 << (shift - 1)
    v = (s0.astype(jnp.int64) * wgt + s1.astype(jnp.int64) * (8 - wgt) +
         off) >> shift
    return jnp.clip(v, 0, (1 << bd) - 1).astype(jnp.int32)


@functools.lru_cache()
def _gpm_tables():
    from . import data as D
    t = D.tables()
    return (t["gpm_angle_idx"], t["gpm_angle_to_weights_idx"],
            t["gpm_weights_offset_x"], t["gpm_weights_offset_y"],
            t["gpm_angle_to_mirror"],
            np.asarray(t["gpm_weights"]).reshape(-1, 112, 112))


def _gpm_weight_block(part, w, h, wl, hl, hs, vs):
    """Host slice of the GPM weight plane for one block: [h, w] int32
    (wl/hl: LUMA block dims for the offset lookup; hs/vs: plane shifts)."""
    angle_idx, a2w, offx, offy, a2m, wmats = _gpm_tables()
    ai = int(angle_idx[part])
    wmat = wmats[int(a2w[ai])]
    wi = (wl.bit_length() - 1) - 3
    hi = (hl.bit_length() - 1) - 3
    off_x = int(offx[part][hi][wi])
    off_y = int(offy[part][hi][wi])
    mirror = int(a2m[ai])
    WS = 112
    wys = np.arange(h) << vs
    wxs = np.arange(w) << hs
    if mirror == 0:
        rows, cols = off_y + wys, off_x + wxs
    elif mirror == 1:
        rows, cols = off_y + wys, WS - 1 - off_x - wxs
    else:
        rows, cols = WS - 1 - off_y - wys, off_x + wxs
    return wmat[np.ix_(rows, cols)].astype(np.int32)


@functools.partial(jax.jit, static_argnames=("bd",))
def _mc_w_avg_batch(s0, s1, denom, w0, w1, o0, o1, bd: int):
    """Weighted bi-prediction (explicit WP / BCW): per-block params
    [B]; mirrors native mc_w_avg (vvc_mc.c)."""
    shift = (denom + max(3, 15 - bd))[:, None, None].astype(jnp.int64)
    off = ((((o0 + o1) << (bd - 8)) + 1).astype(jnp.int64)
           [:, None, None]) << (shift - 1)
    v = (s0.astype(jnp.int64) * w0[:, None, None] +
         s1.astype(jnp.int64) * w1[:, None, None] + off) >> shift
    return jnp.clip(v, 0, (1 << bd) - 1).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("bd",))
def _mc_uni_w_batch(val, denom, wx, ox, bd: int):
    """Weighted uni-prediction: per-block params [B]; mirrors native
    mc_uni_out weighted branch (vvc_mc.c)."""
    shift = (denom + 14 - bd)[:, None, None].astype(jnp.int64)
    off = jnp.int64(1) << (shift - 1)        # shift >= 2 for bd <= 12
    v = ((val.astype(jnp.int64) * wx[:, None, None] + off) >> shift) + \
        (ox.astype(jnp.int64) << (bd - 8))[:, None, None]
    return jnp.clip(v, 0, (1 << bd) - 1).astype(jnp.int32)


def mc_put_batch(ref_plane, xs, ys, frac_x, frac_y, w, h, is_luma, bd,
                 hf_idx=0, vf_idx=0, wrap=0, box=None, mesh=None):
    """Host-facing batched put for one (w, h, frac-class) bucket.

    ref_plane: np.int32 [H, W]; xs/ys/frac_x/frac_y: np arrays [B].
    All blocks in a call share bool(frac_x) / bool(frac_y) (the caller
    buckets by frac-class); per-block fractional phases may differ.
    box: optional [B, 4] inclusive clamp boxes (DMVR prefetch windows).
    mesh: optional jax Mesh with a "tile" axis — the batch partitions
    across its devices (per-bucket fallback to single-device when the
    bucket is smaller than the axis).  Returns np.int32 [B, h, w]
    (14-bit domain)."""
    global sharded_puts
    lf, cf = _filter_banks()
    bank = lf[hf_idx] if is_luma else cf[hf_idx]
    bankv = lf[vf_idx] if is_luma else cf[vf_idx]
    fclass = (1 if frac_x.any() else 0) | (2 if frac_y.any() else 0)
    boxed = box is not None
    B = len(xs)
    if not boxed:
        box = np.zeros((B, 4), np.int32)
    t = mesh.shape["tile"] if mesh is not None else 1
    sharded = mesh is not None and B >= t
    n = _batch_size(B)
    if sharded:
        n = -(-n // t) * t
    args = [jnp.asarray(_pad_batch(np.asarray(a, np.int32), n))
            for a in (xs, ys, bank[frac_x], bankv[frac_y], box)]
    ref = jnp.asarray(np.asarray(ref_plane, np.int32))
    statics = (int(w), int(h), bool(is_luma), int(bd), int(fclass),
               int(wrap), boxed)
    if sharded:
        out = _sharded_put_fn(mesh, statics)(ref, *args)
        sharded_puts += 1
    else:
        out = _mc_put_batch(ref, *args, *statics)
    return np.asarray(out)[:B]


def mc_avg_batch(s0, s1, bd):
    return np.asarray(_mc_avg_batch(jnp.asarray(s0), jnp.asarray(s1),
                                    int(bd)))


def mc_uni_batch(val, bd):
    return np.asarray(_mc_uni_batch(jnp.asarray(val), int(bd)))


# ---- decoder-side batched dispatch ----------------------------------------

PF_L0, PF_L1, PF_BI = 1, 2, 3


def _dmvr_phase(D, rpls, bd):
    """Phase A of DMVR descriptors: batched bilinear prefetch pairs +
    25-point SAD refinement (ops/inter_device.dmvr_refine_batch).
    Returns {(di, sby, sbx): (mv0, mv1, skip_bdof)} with the refined,
    +/-clipped subblock MVs (native dmvr_refine)."""
    from .inter_device import dmvr_refine_batch
    dfilt = _dmvr_filters()
    buckets = {}        # (id(plane), pw, ph, mclass, wrap) -> lists
    slots = {}          # (di, sby, sbx, hyp) -> (bkey, idx)
    subs = []           # (di, sby, sbx, sbw, sbh, mvs)
    for di in np.nonzero((D[:, 13] & 64) != 0)[0]:
        di = int(di)
        x0, y0, w, h = (int(v) for v in D[di, :4])
        packed = int(D[di, 4])
        wrap = int(D[di, 14])
        nsbx, nsby = (packed >> 4) & 63, (packed >> 10) & 63
        sbw, sbh = w // nsbx, h // nsby
        rpl = rpls[int(D[di, 12])]
        refs = (int(D[di, 5]), int(D[di, 6]))
        mvs = ((int(D[di, 7]), int(D[di, 8])),
               (int(D[di, 9]), int(D[di, 10])))
        for sby in range(nsby):
            for sbx in range(nsbx):
                x = x0 + sbx * sbw
                y = y0 + sby * sbh
                subs.append((di, sby, sbx, sbw, sbh, mvs))
                for i in range(2):
                    plane = rpl[i].frames[refs[i]].buffer.planes[0]
                    mvx, mvy = mvs[i]
                    mx, my = mvx & 15, mvy & 15
                    key = (id(plane), sbw + 4, sbh + 4,
                           (1 if mx else 0) | (2 if my else 0), wrap)
                    b = buckets.get(key)
                    if b is None:
                        b = buckets[key] = {"plane": plane, "xs": [],
                                            "ys": [], "fx": [], "fy": []}
                    b["xs"].append(x + (mvx >> 4) - 2)
                    b["ys"].append(y + (mvy >> 4) - 2)
                    b["fx"].append(dfilt[mx])
                    b["fy"].append(dfilt[my])
                    slots[(di, sby, sbx, i)] = (key, len(b["xs"]) - 1)
    vals = {}
    for key, b in buckets.items():
        _pid, pw, ph, mclass, wrap = key
        vals[key] = np.asarray(_dmvr_bilin_batch(
            jnp.asarray(b["plane"]), jnp.asarray(_pad_batch(b["xs"])),
            jnp.asarray(_pad_batch(b["ys"])),
            jnp.asarray(_pad_batch(b["fx"])),
            jnp.asarray(_pad_batch(b["fy"])), pw, ph, int(bd), mclass,
            wrap))[:len(b["xs"])]
    out = {}
    by_size = {}
    for di, sby, sbx, sbw, sbh, mvs in subs:
        by_size.setdefault((sbw, sbh), []).append((di, sby, sbx, mvs))
    for (sbw, sbh), items in by_size.items():
        t0 = np.stack([vals[slots[(di, sby, sbx, 0)][0]]
                       [slots[(di, sby, sbx, 0)][1]]
                       for di, sby, sbx, _ in items])
        t1 = np.stack([vals[slots[(di, sby, sbx, 1)][0]]
                       [slots[(di, sby, sbx, 1)][1]]
                       for di, sby, sbx, _ in items])
        dmv, skip = dmvr_refine_batch(_pad_batch(t0), _pad_batch(t1),
                                      sbw, sbh)
        lim = 1 << 17
        for j, (di, sby, sbx, mvs) in enumerate(items):
            dx, dy = int(dmv[j, 0]), int(dmv[j, 1])
            if dx or dy:
                mv0 = (min(max(mvs[0][0] + dx, -lim), lim - 1),
                       min(max(mvs[0][1] + dy, -lim), lim - 1))
                mv1 = (min(max(mvs[1][0] - dx, -lim), lim - 1),
                       min(max(mvs[1][1] - dy, -lim), lim - 1))
            else:
                mv0, mv1 = mvs
            out[(di, sby, sbx)] = (mv0, mv1, bool(skip[j]))
    return out


def _expand_dmvr_bdof(d, di, rpl, native_jobs, nc, hs, vs, add_put,
                      entries, refined, pic_w, pic_h):
    """Expand a DMVR/BDOF descriptor: per-subblock box-clamped puts with
    the refined MVs (native luma_bi/chroma_bi has_box path), BDOF ring
    gathers where the per-subblock gate holds, plain-average finals
    (DMVR/BDOF imply no weights), and the refined-MV writeback to the
    TMVP col grids (native set_dmvr_info)."""
    (x0, y0, w, h, packed, r0_, r1_, mx0, my0, mx1, my1, hpel, tag,
     flags2, wrap, _wm) = (int(v) for v in d[:16])
    dmvr = bool(flags2 & 64)
    bdof = bool(flags2 & 128)
    nsbx, nsby = (packed >> 4) & 63, (packed >> 10) & 63
    sbw, sbh = w // nsbx, h // nsby
    refs = (r0_, r1_)
    orig = ((mx0, my0), (mx1, my1))
    lm = bool(flags2 & 1)
    nr = native_jobs[tag][0]
    tabs = nr.tabs
    for sby in range(nsby):
        for sbx in range(nsbx):
            x = x0 + sbx * sbw
            y = y0 + sby * sbh
            if dmvr:
                mv0, mv1, skip = refined[(di, sby, sbx)]
                sb_bdof = bdof and not skip
                # set_dmvr_info: refined MVs -> TMVP col grids
                ya, xa = y >> 2, x >> 2
                y1, x1 = (y + sbh) >> 2, (x + sbw) >> 2
                tabs.col_pf[ya:y1, xa:x1] = 3            # PF_BI
                for lx, mv in ((0, mv0), (1, mv1)):
                    tabs.col_mv[lx, ya:y1, xa:x1] = mv
                    tabs.col_ref[lx, ya:y1, xa:x1] = refs[lx]
            else:
                mv0, mv1, sb_bdof = orig[0], orig[1], bdof
            mvs = (mv0, mv1)
            slots = []
            rings = []
            for i in range(2):
                ref = rpl[i].frames[refs[i]].buffer.planes[0]
                mvx, mvy = mvs[i]
                fx, fy = mvx & 15, mvy & 15
                xi, yi = x + (mvx >> 4), y + (mvy >> 4)
                box = _dmvr_box(x + (orig[i][0] >> 4),
                                y + (orig[i][1] >> 4), sbw, sbh, True,
                                pic_w, pic_h) if dmvr else None
                slots.append(add_put(ref, xi, yi, fx, fy, sbw, sbh, True,
                                     hpel, wrap, box))
                if sb_bdof:
                    rings.append(add_put(
                        ref, xi + (fx >> 3) - 1, yi + (fy >> 3) - 1, 0, 0,
                        sbw + 2, sbh + 2, True, 0, wrap, box))
            wp = ("bdof", rings[0], rings[1]) if sb_bdof else None
            entries.append((tag, 0, x, y, sbw, sbh, slots, wp, lm))
            if nc == 1:
                continue
            for c in (1, 2):
                cslots = []
                for i in range(2):
                    ref = rpl[i].frames[refs[i]].buffer.planes[c]
                    mvx, mvy = mvs[i]
                    cfx = (mvx & ((1 << (4 + hs)) - 1)) << (1 - hs)
                    cfy = (mvy & ((1 << (4 + vs)) - 1)) << (1 - vs)
                    xi = (x >> hs) + (mvx >> (4 + hs))
                    yi = (y >> vs) + (mvy >> (4 + vs))
                    box = _dmvr_box(
                        (x >> hs) + (orig[i][0] >> (4 + hs)),
                        (y >> vs) + (orig[i][1] >> (4 + vs)),
                        sbw >> hs, sbh >> vs, False,
                        pic_w >> hs, pic_h >> vs) if dmvr else None
                    cslots.append(add_put(ref, xi, yi, cfx, cfy,
                                          sbw >> hs, sbh >> vs, False, 0,
                                          wrap >> hs, box))
                entries.append((tag, c, x >> hs, y >> vs, sbw >> hs,
                                sbh >> vs, cslots, None, False))


def _expand_subblocks(d, rpl, native_jobs, nc, hs, vs, add_put, entries,
                      prof_jobs):
    """Expand an affine / subblock-grid descriptor into per-subblock put
    slots + finals entries, mirroring native pred_affine_blk /
    pred_regular_blk's nsb walk: luma per subblock (affine: the type-2
    filter and optional PROF refinement; grid: the stored hpel filter),
    chroma per subblock (grid) or per 2x2-group with the spec's averaged
    MV (affine)."""
    (x0, y0, w, h, packed, r0_, r1_, _m7, _m8, _m9, _m10, hpel0, tag,
     flags2, wrap, wmask) = (int(v) for v in d[:16])
    affine = bool(flags2 & 4)
    nsbx, nsby = (packed >> 4) & 63, (packed >> 10) & 63
    sbw, sbh = w // nsbx, h // nsby
    prof = ((flags2 >> 4) & 1, (flags2 >> 5) & 1)
    nr = native_jobs[tag][0]
    tabs = nr.tabs
    lm = bool(flags2 & 1)
    cu_pf = packed & 3
    dm = {}
    if affine:
        cy0, cx0 = y0 >> 2, x0 >> 2
        num_cp = int(tabs.mmi[cy0, cx0]) + 1
        for lx in range(2):
            if prof[lx] and (cu_pf & (lx + 1)):
                dm[lx] = _affine_diff_mvs(tabs.cp_mv[lx, cy0, cx0],
                                          num_cp, w, h)

    def wparams(c):
        return tuple(int(v) for v in d[16 + 5 * c:21 + 5 * c]) \
            if (wmask >> c) & 1 else None

    def luma_put(lx, mv, ref_i, x, y, with_prof, hf):
        ref = rpl[lx].frames[ref_i].buffer.planes[0]
        mvx, mvy = int(mv[0]), int(mv[1])
        fx, fy = mvx & 15, mvy & 15
        xi, yi = x + (mvx >> 4), y + (mvy >> 4)
        slot = add_put(ref, xi, yi, fx, fy, sbw, sbh, True, hf, wrap)
        if with_prof:
            # 6x6 integer-sample ring: an fclass-0 put (<< (14-bd))
            ring = add_put(ref, xi + (fx >> 3) - 1, yi + (fy >> 3) - 1,
                           0, 0, 6, 6, True, 0, wrap)
            dx, dy = dm[lx]
            prof_jobs.append((slot, ring, dx, dy))
        return slot

    def chroma_put(c, lx, mv, ref_i, xc, yc, wc, hc):
        ref = rpl[lx].frames[ref_i].buffer.planes[c]
        mvx, mvy = int(mv[0]), int(mv[1])
        fx = (mvx & ((1 << (4 + hs)) - 1)) << (1 - hs)
        fy = (mvy & ((1 << (4 + vs)) - 1)) << (1 - vs)
        xi = xc + (mvx >> (4 + hs))
        yi = yc + (mvy >> (4 + vs))
        return add_put(ref, xi, yi, fx, fy, wc, hc, False, 0, wrap >> hs)

    for sby in range(nsby):
        for sbx in range(nsbx):
            x = x0 + sbx * sbw
            y = y0 + sby * sbh
            cy, cx = y >> 2, x >> 2
            spf = int(tabs.mvf_pf[cy, cx])
            hyps = [lx for lx in (0, 1) if spf & (lx + 1)]
            hf = 2 if affine else int(tabs.mvf_hpel[cy, cx])
            if not hyps:
                continue
            slots = [
                luma_put(lx, tabs.mvf_mv[lx, cy, cx],
                         int(tabs.mvf_ref[lx, cy, cx]), x, y,
                         affine and prof[lx], hf)
                for lx in hyps]
            entries.append((tag, 0, x, y, sbw, sbh, slots, wparams(0), lm))
            if nc == 1:
                continue
            if affine:
                # per 2x2 group (4:2:0): spec-averaged MV over the pair
                if (sby & vs) or (sbx & hs):
                    continue
                cy2 = (y + vs * sbh) >> 2
                cx2 = (x + hs * sbw) >> 2
                for c in (1, 2):
                    slots = []
                    for lx in hyps:
                        m = tabs.mvf_mv[lx, cy, cx].astype(np.int64) + \
                            tabs.mvf_mv[lx, cy2, cx2]
                        mvc = (m + 1 - (m >= 0)) >> 1
                        slots.append(chroma_put(
                            c, lx, mvc, int(tabs.mvf_ref[lx, cy, cx]),
                            x >> hs, y >> vs,
                            (sbw << hs) >> hs, (sbh << vs) >> vs))
                    entries.append((tag, c, x >> hs, y >> vs,
                                    (sbw << hs) >> hs, (sbh << vs) >> vs,
                                    slots, wparams(c), False))
            else:
                for c in (1, 2):
                    slots = [
                        chroma_put(c, lx, tabs.mvf_mv[lx, cy, cx],
                                   int(tabs.mvf_ref[lx, cy, cx]),
                                   x >> hs, y >> vs, sbw >> hs, sbh >> vs)
                        for lx in hyps]
                    entries.append((tag, c, x >> hs, y >> vs, sbw >> hs,
                                    sbh >> vs, slots, wparams(c), False))


def frame_device_mc(native_jobs, sps, bd, mesh=None):
    """Whole-frame batched device MC for the regular (non-subblock) blocks
    of every native inter job, including explicit-weighted-prediction /
    BCW finals, LMCS forward mapping, and horizontal wraparound; complex
    blocks (affine/GPM/CIIP/DMVR/BDOF) run the host C path inside the same
    collect call (native/vvc_inter.c inter_ctus_dev; descriptor layout
    documented there).

    native_jobs: [(NativeRecon, ctus)].  Puts batch per (ref plane, size,
    filter class); the uni/bi/weighted finals batch per size."""
    descs = []
    rpls = []
    for tag, (nr, ctus) in enumerate(native_jobs):
        d = nr.predict_inter_ctus_dev(ctus, tag)
        rpls.append(nr.rpl)
        if len(d):
            descs.append(d)
    if not descs:
        return
    D = np.concatenate(descs)
    nc = 3 if sps.chroma_format_idc else 1
    hs, vs = (sps.hshift[1], sps.vshift[1]) if nc > 1 else (0, 0)

    put_buckets = {}      # key -> dict(plane, xs, ys, fx, fy, out slots)
    entries = []          # (tag, c, xc, yc, wc, hc, slots, wparams, lmcs)
    prof_jobs = []        # (val_slot, ring_slot, dmx44, dmy44)
    pic_h, pic_w = native_jobs[0][0].fb.planes[0].shape
    dmvr_refined = _dmvr_phase(D, rpls, bd) \
        if ((D[:, 13] & 64) != 0).any() else {}

    def add_put(plane, xi, yi, fx, fy, w, h, is_luma, hf_idx, wrap,
                box=None):
        # bucket by actual frac class so fclass is uniform per launch
        key = (id(plane), w, h, is_luma, hf_idx, bool(fx), bool(fy), wrap,
               box is not None)
        b = put_buckets.get(key)
        if b is None:
            b = put_buckets[key] = {"plane": plane, "xs": [], "ys": [],
                                    "fx": [], "fy": [], "w": w, "h": h,
                                    "is_luma": is_luma, "hf": hf_idx,
                                    "wrap": wrap,
                                    "box": [] if box is not None else None}
        b["xs"].append(xi)
        b["ys"].append(yi)
        b["fx"].append(fx)
        b["fy"].append(fy)
        if box is not None:
            b["box"].append(box)
        return (key, len(b["xs"]) - 1)

    for di in range(len(D)):
        (x0, y0, w, h, pf, r0, r1, mx0, my0, mx1, my1, hpel, tag,
         flags2, wrap, wmask) = (int(v) for v in D[di, :16])
        rpl = rpls[tag]
        if flags2 & 2:
            # GPM: two uni hypotheses per plane + weight-plane blend
            lx0, lx1, part = (int(v) for v in D[di, 16:19])
            for c in range(nc):
                chs, cvs = (0, 0) if c == 0 else (hs, vs)
                wc, hc = w >> chs, h >> cvs
                slots = []
                for i, (lx, ref_i, mvx, mvy) in enumerate(
                        ((lx0, r0, mx0, my0), (lx1, r1, mx1, my1))):
                    ref = rpl[lx].frames[ref_i].buffer.planes[c]
                    if c == 0:
                        fx, fy = mvx & 15, mvy & 15
                        xi = x0 + (mvx >> 4)
                        yi = y0 + (mvy >> 4)
                    else:
                        fx = (mvx & ((1 << (4 + chs)) - 1)) << (1 - chs)
                        fy = (mvy & ((1 << (4 + cvs)) - 1)) << (1 - cvs)
                        xi = (x0 >> chs) + (mvx >> (4 + chs))
                        yi = (y0 >> cvs) + (mvy >> (4 + cvs))
                    slots.append(add_put(ref, xi, yi, fx, fy, wc, hc,
                                         c == 0, 0, wrap >> chs))
                wgt = _gpm_weight_block(part, wc, hc, w, h, chs, cvs)
                entries.append((tag, c, x0 >> chs, y0 >> cvs, wc, hc,
                                slots, ("gpm", wgt),
                                (flags2 & 1) and c == 0))
            continue
        if flags2 & 12:
            # affine (bit2) / subblock grid (bit3): expand per-subblock
            # MVs from the frame's mvf/cp_mv tab grids
            _expand_subblocks(
                D[di], rpl, native_jobs, nc, hs, vs, add_put, entries,
                prof_jobs)
            continue
        if flags2 & 192:
            # DMVR (bit6) / BDOF (bit7): refined MVs from phase A,
            # box-clamped puts + BDOF rings, col-grid writeback
            _expand_dmvr_bdof(
                D[di], di, rpl, native_jobs, nc, hs, vs, add_put,
                entries, dmvr_refined, pic_w, pic_h)
            continue
        hyps = [0] if pf == PF_L0 else [1] if pf == PF_L1 else [0, 1]
        for c in range(nc):
            chs, cvs = (0, 0) if c == 0 else (hs, vs)
            wc, hc = w >> chs, h >> cvs
            slots = []
            for lx in hyps:
                ref = rpl[lx].frames[[r0, r1][lx]].buffer.planes[c]
                mvx, mvy = (mx0, my0) if lx == 0 else (mx1, my1)
                if c == 0:
                    fx, fy = mvx & 15, mvy & 15
                    xi = x0 + (mvx >> 4)
                    yi = y0 + (mvy >> 4)
                    hf_idx = hpel
                else:
                    fx = (mvx & ((1 << (4 + chs)) - 1)) << (1 - chs)
                    fy = (mvy & ((1 << (4 + cvs)) - 1)) << (1 - cvs)
                    xi = (x0 >> chs) + (mvx >> (4 + chs))
                    yi = (y0 >> cvs) + (mvy >> (4 + cvs))
                    hf_idx = 0
                slots.append(add_put(ref, xi, yi, fx, fy, wc, hc,
                                     c == 0, hf_idx, wrap >> chs))
            wparams = tuple(int(v) for v in D[di, 16 + 5 * c:21 + 5 * c]) \
                if (wmask >> c) & 1 else None
            lm = (flags2 & 1) and c == 0
            entries.append((tag, c, x0 >> chs, y0 >> cvs, wc, hc, slots,
                            wparams, lm))

    vals = {}
    for key, b in put_buckets.items():
        vals[key] = mc_put_batch(
            b["plane"], np.asarray(b["xs"], np.int32),
            np.asarray(b["ys"], np.int32), np.asarray(b["fx"], np.int32),
            np.asarray(b["fy"], np.int32), b["w"], b["h"], b["is_luma"],
            bd, b["hf"], b["hf"], b["wrap"], b["box"], mesh=mesh)

    prof_out = {}
    if prof_jobs:
        # batched PROF refinement overrides the affine put slots
        refined = np.asarray(_prof_apply_batch(
            jnp.asarray(_pad_batch([vals[k][i] for (k, i), _, _, _
                                    in prof_jobs])),
            jnp.asarray(_pad_batch([vals[k][i] for _, (k, i), _, _
                                    in prof_jobs])),
            jnp.asarray(_pad_batch([dx for _, _, dx, _ in prof_jobs])),
            jnp.asarray(_pad_batch([dy for _, _, _, dy in prof_jobs])),
            int(bd)))
        for j, (slot, _, _, _) in enumerate(prof_jobs):
            prof_out[slot] = refined[j]

    def val_of(slot):
        out = prof_out.get(slot)
        if out is not None:
            return out
        k, i = slot
        return vals[k][i]

    # finals: batch uni/bi/weighted combines per (size, kind)
    finals = {}   # (w, h, kind) -> (s0, s1, wparams, writebacks)
    for tag, c, xc, yc, wc, hc, slots, wp, lm in entries:
        dstplane = native_jobs[tag][0].fb.planes[c]
        wb = (dstplane, xc, yc,
              getattr(native_jobs[tag][0], "lmcs_fwd_np", None)
              if lm else None)
        if len(slots) == 1:
            kind = "uni_w" if wp else "uni"
            f = finals.setdefault((wc, hc, kind), ([], None, [], []))
            f[0].append(val_of(slots[0]))
            f[2].append(wp)
            f[3].append(wb)
        else:
            if isinstance(wp, tuple) and wp[0] in ("gpm", "bdof"):
                kind = wp[0]
            else:
                kind = "bi_w" if wp else "bi"
            f = finals.setdefault((wc, hc, kind), ([], [], [], []))
            f[0].append(val_of(slots[0]))
            f[1].append(val_of(slots[1]))
            f[2].append(wp)
            f[3].append(wb)
    _p2 = _pad_batch      # pad rows never write back
    for (wc, hc, kind), (s0, s1, wps, wbs) in finals.items():
        if kind == "bi":
            out = mc_avg_batch(_p2(s0), _p2(s1), bd)
        elif kind == "uni":
            out = mc_uni_batch(_p2(s0), bd)
        elif kind == "gpm":
            out = np.asarray(_mc_gpm_batch(
                jnp.asarray(_p2(s0)), jnp.asarray(_p2(s1)),
                jnp.asarray(_p2([wgt for _, wgt in wps])), int(bd)))
        elif kind == "bdof":
            out = np.asarray(_bdof_full_batch(
                jnp.asarray(_p2(s0)), jnp.asarray(_p2(s1)),
                jnp.asarray(_p2([val_of(r0) for _, r0, _ in wps])),
                jnp.asarray(_p2([val_of(r1) for _, _, r1 in wps])),
                wc, hc, int(bd)))
        elif kind == "bi_w":
            wa = _p2(np.asarray(wps, np.int32))
            out = np.asarray(_mc_w_avg_batch(
                jnp.asarray(_p2(s0)), jnp.asarray(_p2(s1)),
                *(jnp.asarray(wa[:, i]) for i in range(5)), int(bd)))
        else:                          # uni_w: (denom, w0, _, o0, _)
            wa = _p2(np.asarray(wps, np.int32))
            out = np.asarray(_mc_uni_w_batch(
                jnp.asarray(_p2(s0)), jnp.asarray(wa[:, 0]),
                jnp.asarray(wa[:, 1]), jnp.asarray(wa[:, 3]), int(bd)))
        for i, (plane, xc, yc, lut) in enumerate(wbs):
            blk = out[i]
            if lut is not None:
                # LMCS forward mapping on the inter luma prediction
                # (predict_inter, vvc_inter.c:888-891)
                blk = lut[blk]
            plane[yc:yc + hc, xc:xc + wc] = blk
