"""Device DMVR refinement + BDOF: batched subblock kernels.

Batched formulation of the reference's DMVR/BDOF units
(/root/reference/libavcodec/x86/vvc/vvc_inter.asm SAD,
vvc_inter_template.c:237-323 BDOF, vvc_inter.c:642-748 refine): all
DMVR/BDOF subblocks of a frame are fixed-size stencils, so each becomes a
single batched launch —

* `dmvr_refine_batch`: 25-point SAD search over the bilinear-prefetched
  pair [B, bh+4, bw+4] + the 3-step parametric division, vectorized over
  subblocks with the reference's exact tie-breaking (center-first order,
  strict-< replacement, the center's sad -= sad>>2 handicap).
* `bdof_batch`: per-4x4-cell gradient sums and vx/vy solve over the
  [B, h+2, w+2] integer-ring windows (bit_length computed with exact
  integer compares — float log2 would mis-round).

Bit-exact vs the host golden (inter.py _dmvr_refine / _apply_bdof), pinned
by tests/test_device_inter.py; the in-decoder dispatch stays host-side
(the refined MVs feed chroma MC and the TMVP grids mid-walk)."""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp


def _bit_length(x):
    """Exact integer bit_length for x >= 0 (31 compares, vectorized)."""
    bl = jnp.zeros_like(x)
    for i in range(31):
        bl = bl + (x >= (1 << i)).astype(x.dtype)
    return bl


# scan order: center first (strict-< replacement semantics), then the
# golden model's dy-major scan skipping the center
_OFFS = [(2, 2)] + [(dy, dx) for dy in range(5) for dx in range(5)
                    if (dy, dx) != (2, 2)]


@functools.partial(jax.jit, static_argnames=("bw", "bh"))
def _dmvr_refine(t0, t1, bw: int, bh: int):
    sads = []
    for dy, dx in _OFFS:
        a = t0[:, dy:dy + bh:2, dx:dx + bw]
        b = t1[:, 4 - dy:4 - dy + bh:2, 4 - dx:4 - dx + bw]
        sads.append(jnp.abs(a - b).sum(axis=(1, 2)))
    sad = jnp.stack(sads, axis=1)                       # [B, 25]
    center = sad[:, 0] - (sad[:, 0] >> 2)
    sad = sad.at[:, 0].set(center)
    search = center >= bw * bh
    best = jnp.argmin(sad, axis=1)                      # first occurrence
    best = jnp.where(search, best, 0)
    offs = jnp.asarray(np.asarray(_OFFS, np.int32))
    mdy = offs[best, 0]
    mdx = offs[best, 1]
    min_sad = jnp.take_along_axis(sad, best[:, None], axis=1)[:, 0]

    def sad_at(dy, dx):
        # map (dy, dx) -> scan index; center sits at 0
        lut = np.zeros((5, 5), np.int32)
        for i, (y, x) in enumerate(_OFFS):
            lut[y, x] = i
        idx = jnp.asarray(lut)[dy, dx]
        return jnp.take_along_axis(sad, idx[:, None], axis=1)[:, 0]

    def refine(sm, sc, sp):
        denom = ((sm + sp) - (sc << 1)) << 3
        num = (sm - sp) << 4
        sign = num < 0
        anum = jnp.abs(num)
        q = jnp.zeros_like(anum)
        d = denom
        for _ in range(3):
            # no d > 0 guard: the golden loop keeps dividing the shifted
            # denominator even when it reaches 0 (anum >= 0 then holds)
            q = q << 1
            ge = anum >= d
            anum = jnp.where(ge, anum - d, anum)
            q = jnp.where(ge, q + 1, q)
            d = d >> 1
        q = jnp.where(sign, -q, q)
        return jnp.where(denom == 0, 0,
                         jnp.where(sm == sc, -8,
                                   jnp.where(sp == sc, 8, q)))

    inner = (mdx != 0) & (mdx != 4) & (mdy != 0) & (mdy != 4) & search
    cdx = jnp.clip(mdx, 1, 3)
    cdy = jnp.clip(mdy, 1, 3)
    rx = refine(sad_at(cdy, cdx - 1), sad_at(cdy, cdx),
                sad_at(cdy, cdx + 1))
    ry = refine(sad_at(cdy - 1, cdx), sad_at(cdy, cdx),
                sad_at(cdy + 1, cdx))
    dmvx = jnp.where(search, (mdx - 2) << 4, 0) + jnp.where(inner, rx, 0)
    dmvy = jnp.where(search, (mdy - 2) << 4, 0) + jnp.where(inner, ry, 0)
    skip = min_sad < 2 * bw * bh
    return jnp.stack([dmvx, dmvy], axis=1), skip


def dmvr_refine_batch(t0, t1, bw, bh):
    """t0/t1: np.int32 [B, bh+4, bw+4] bilinear-prefetched pair (10-bit
    domain).  Returns (dmv [B, 2] int32 in 1/16-pel, skip_bdof [B] bool)."""
    dmv, skip = _dmvr_refine(jnp.asarray(t0), jnp.asarray(t1),
                             int(bw), int(bh))
    return np.asarray(dmv), np.asarray(skip)


@functools.partial(jax.jit, static_argnames=("w", "h", "bd"))
def _bdof(s0p, s1p, w: int, h: int, bd: int):
    B = s0p.shape[0]

    def grads(sp):
        gh = (sp[:, 1:1 + h, 2:2 + w] >> 6) - (sp[:, 1:1 + h, 0:w] >> 6)
        gv = (sp[:, 2:2 + h, 1:1 + w] >> 6) - (sp[:, 0:h, 1:1 + w] >> 6)
        pad = [(0, 0), (1, 1), (1, 1)]
        return jnp.pad(gh, pad, mode="edge"), jnp.pad(gv, pad, mode="edge")

    gh0, gv0 = grads(s0p)
    gh1, gv1 = grads(s1p)
    sp0 = jnp.pad(s0p[:, 1:1 + h, 1:1 + w], [(0, 0), (1, 1), (1, 1)],
                  mode="edge")
    sp1 = jnp.pad(s1p[:, 1:1 + h, 1:1 + w], [(0, 0), (1, 1), (1, 1)],
                  mode="edge")
    shift4 = 15 - bd
    off4 = 1 << (shift4 - 1)
    out = jnp.zeros((B, h, w), jnp.int32)
    for by in range(0, h, 4):
        for bx in range(0, w, 4):
            w0 = sp0[:, by:by + 6, bx:bx + 6]
            w1 = sp1[:, by:by + 6, bx:bx + 6]
            diff = (w0 >> 4) - (w1 >> 4)
            th = (gh0[:, by:by + 6, bx:bx + 6] +
                  gh1[:, by:by + 6, bx:bx + 6]) >> 1
            tv = (gv0[:, by:by + 6, bx:bx + 6] +
                  gv1[:, by:by + 6, bx:bx + 6]) >> 1
            sgx2 = jnp.abs(th).sum(axis=(1, 2))
            sgy2 = jnp.abs(tv).sum(axis=(1, 2))
            sgxgy = (jnp.sign(tv) * th).sum(axis=(1, 2))
            sgxdi = (-jnp.sign(th) * diff).sum(axis=(1, 2))
            sgydi = (-jnp.sign(tv) * diff).sum(axis=(1, 2))
            thres = 16
            vx = jnp.where(
                sgx2 > 0,
                jnp.clip((sgxdi << 2) >> (_bit_length(sgx2) - 1),
                         -thres + 1, thres - 1), 0)
            vy = jnp.where(
                sgy2 > 0,
                jnp.clip(((sgydi << 2) - ((vx * sgxgy) >> 1)) >>
                         (_bit_length(sgy2) - 1), -thres + 1, thres - 1),
                0)
            dgh = gh0[:, by + 1:by + 5, bx + 1:bx + 5] - \
                gh1[:, by + 1:by + 5, bx + 1:bx + 5]
            dgv = gv0[:, by + 1:by + 5, bx + 1:bx + 5] - \
                gv1[:, by + 1:by + 5, bx + 1:bx + 5]
            boff = vx[:, None, None] * dgh + vy[:, None, None] * dgv
            c0 = s0p[:, 1 + by:5 + by, 1 + bx:5 + bx]
            c1 = s1p[:, 1 + by:5 + by, 1 + bx:5 + bx]
            cell = (c0 + off4 + c1 + boff) >> shift4
            out = out.at[:, by:by + 4, bx:bx + 4].set(cell)
    return jnp.clip(out, 0, (1 << bd) - 1)


def bdof_batch(s0p, s1p, bd):
    """s0p/s1p: np.int32 [B, h+2, w+2] 14-bit blocks with the integer
    border ring (bdof_fetch_samples layout).  Returns pixels [B, h, w]."""
    h, w = s0p.shape[1] - 2, s0p.shape[2] - 2
    return np.asarray(_bdof(jnp.asarray(s0p), jnp.asarray(s1p),
                            int(w), int(h), int(bd)))
