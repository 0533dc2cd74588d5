"""Mesh-sharded in-loop filters: real decoded frames over a (gop, tile) mesh.

Device replacement for the reference's cross-frame/cross-row concurrency
engine (/root/reference/libavcodec/vvc/vvc_thread.c:41-51 task stencil +
vvc_refs.c:532-565 row-progress listeners): instead of per-CTU tasks with
row-progress pub/sub, whole-frame filter passes run as one shard_map over a
jax.sharding.Mesh —

  * "gop"  axis: independent frames (the reference's 16-deep frame pipeline,
    vvcdec.c:830-841) decode their pixel passes on different devices;
  * "tile" axis: CTU-row slabs of each frame (the reference's CTU wavefront)
    on different devices, with the 1-pixel SAO neighbour ring crossing slab
    boundaries via jax.lax.ppermute (the collective form of the
    sao_pixel_buffer_h/v line buffers, vvc_filter.c:123-152).

ALF/CC-ALF tap planes are host-gathered per pixel (ops/alf_device.py), so
those passes are purely elementwise and shard with no halo at all.

All passes are bit-exact vs the host golden filters; VVCDecoder uses them
when `DecoderConfig.mesh_shape` spans more than one device (decoder.py
filter stage), with frame batching across all-intra runs and per-frame
drains at inter reference barriers.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from .mesh import exchange_row_halo
from ..ops.sao_device import _sao_math
from ..ops.alf_device import _alf_math, _cc_math
from ..ops.deblock_device import (_luma_math, _chroma_math, _pad_pow2,
                                  rasterize_deblock)


def make_mesh_exact(shape, devices=None) -> Mesh:
    """("gop", "tile") mesh with exactly the requested shape."""
    g, t = shape
    if devices is None:
        devices = jax.devices()
    if g * t > len(devices):
        raise ValueError(f"mesh_shape {shape} needs {g * t} devices, "
                         f"have {len(devices)}")
    return Mesh(np.array(devices[:g * t]).reshape(g, t), ("gop", "tile"))


# jit cache: (id-key of mesh, kind, shapes/consts) -> compiled fn
_CACHE = {}


def _pad_rows(a, t, mode):
    """Pad axis -2 up to a multiple of t ('edge' for pixels so the bottom
    halo replicates the true frame edge; zeros for parameter maps)."""
    h = a.shape[-2]
    ph = (-h) % t
    if not ph:
        return a, h
    pad = [(0, 0)] * a.ndim
    pad[-2] = (0, ph)
    return np.pad(a, pad, mode=mode), h


def _pad_frames(arrs, g):
    """Pad the leading frame axis of each array to a multiple of g with
    zeros (zero maps are exact filter identities)."""
    f = arrs[0].shape[0]
    pf = (-f) % g
    if not pf:
        return arrs, f
    out = []
    for a in arrs:
        pad = [(0, 0)] * a.ndim
        pad[0] = (0, pf)
        out.append(np.pad(a, pad))
    return out, f


def _sao_fn(mesh, F, H, W, shift, pix_max):
    key = (id(mesh), "sao", F, H, W, shift, pix_max)
    fn = _CACHE.get(key)
    if fn is not None:
        return fn
    t = mesh.shape["tile"]

    def one(src, typ, m1, offs, keep, above, below, idx):
        # src [h, W] pre-SAO slab; halo rows from vertical slab neighbours
        # (frame edges replicate the border row, matching np.pad edge mode)
        top = jnp.where(idx == 0, src[:1], above)
        bot = jnp.where(idx == t - 1, src[-1:], below)
        tall = jnp.concatenate([top, src, bot], axis=0)
        pad = jnp.concatenate([tall[:, :1], tall, tall[:, -1:]], axis=1)
        return _sao_math(pad, typ, m1, offs, keep, shift, pix_max)

    def local(src, typ, m1, offs, keep):
        above, below = exchange_row_halo(src, 1, t)
        idx = jax.lax.axis_index("tile")
        return jax.vmap(one, in_axes=(0, 0, 0, 0, 0, 0, 0, None))(
            src, typ, m1, offs, keep, above, below, idx)

    fn = jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(P("gop", "tile", None), P("gop", "tile", None),
                  P("gop", "tile", None), P("gop", None, "tile", None),
                  P("gop", "tile", None)),
        out_specs=P("gop", "tile", None)))
    _CACHE[key] = fn
    return fn


def _alf_fn(mesh, F, H, W, pix_max):
    key = (id(mesh), "alf", F, H, W, pix_max)
    fn = _CACHE.get(key)
    if fn is not None:
        return fn

    def local(cur, v0, v1, cf, cl, vb):
        return jax.vmap(
            lambda c, a, b, f, l, v: _alf_math(c, a, b, f, l, v, pix_max))(
            cur, v0, v1, cf, cl, vb)

    fn = jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(P("gop", "tile", None), P("gop", None, "tile", None),
                  P("gop", None, "tile", None), P("gop", None, "tile", None),
                  P("gop", None, "tile", None), P("gop", "tile", None)),
        out_specs=P("gop", "tile", None)))
    _CACHE[key] = fn
    return fn


def _cc_fn(mesh, F, H, W, half, pix_max):
    key = (id(mesh), "cc", F, H, W, half, pix_max)
    fn = _CACHE.get(key)
    if fn is not None:
        return fn

    def local(dst, curl, v, cf):
        return jax.vmap(
            lambda d, c, vv, f: _cc_math(d, c, vv, f, half, pix_max))(
            dst, curl, v, cf)

    fn = jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(P("gop", "tile", None), P("gop", "tile", None),
                  P("gop", None, "tile", None), P("gop", None, "tile", None)),
        out_specs=P("gop", "tile", None)))
    _CACHE[key] = fn
    return fn


_DB_HALO = 8      # deblock windows/writes reach <=8 rows past a segment


def _deblock_fn(mesh, kind, F, B, Hp, W, vertical, pix_max):
    key = (id(mesh), "db", kind, F, B, Hp, W, vertical, pix_max)
    fn = _CACHE.get(key)
    if fn is not None:
        return fn
    t = mesh.shape["tile"]
    hs = Hp // t
    math = _luma_math if kind == "luma" else _chroma_math

    def local(slab, px, py, tc, beta, mlp, mlq, x7):
        # slab [F_loc, hs, W]; segment params [F_loc, B] replicated over
        # "tile" — each shard evaluates every segment but keeps only the
        # deltas landing in its own rows (edge shards replicate border
        # rows into the halo, matching the whole-frame clip-gather)
        above, below = exchange_row_halo(slab, _DB_HALO, t)
        i = jax.lax.axis_index("tile")
        top = jnp.where(i == 0,
                        jnp.repeat(slab[:, :1], _DB_HALO, axis=1), above)
        bot = jnp.where(i == t - 1,
                        jnp.repeat(slab[:, -1:], _DB_HALO, axis=1), below)
        tall = jnp.concatenate([top, slab, bot], axis=1)
        row0 = i * hs - _DB_HALO
        out = jax.vmap(lambda p, a, b, c, d, e, f, g: math(
            p, a, b, c, d, e, f, g, vertical, pix_max, row0, hs))(
            tall, px, py, tc, beta, mlp, mlq, x7)
        return out[:, _DB_HALO:_DB_HALO + hs]

    fn = jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(P("gop", "tile", None),) + (P("gop", None),) * 7,
        out_specs=P("gop", "tile", None)))
    _CACHE[key] = fn
    return fn


def deblock_batch_sharded(mesh, planes, segs_per_frame, kind, vertical,
                          pix_max):
    """One deblock direction for a batch of frames: planes [F, H, W]
    np.int32, segs_per_frame a list of per-frame segment tuples (see
    ops/deblock_device._Rasterizer).  Frames shard over "gop", row slabs
    over "tile" with an 8-row ppermute halo; padded segments (tc=0,
    ml=0) are exact no-ops."""
    g, t = mesh.shape["gop"], mesh.shape["tile"]
    # every slab must be at least one halo tall (the halo exchange reaches
    # one neighbour only): pad rows up to t * max(halo, ceil(H/t))
    H = planes.shape[1]
    hs = max(_DB_HALO, -(-H // t))
    ph = hs * t - H
    if ph:
        planes = np.pad(planes, [(0, 0), (0, ph), (0, 0)], mode="edge")
    B = _pad_pow2(max(max((len(s) for s in segs_per_frame), default=1), 1))
    F0 = planes.shape[0]
    seg = np.zeros((F0, 7, B), np.int32)
    for f, s in enumerate(segs_per_frame):
        if s:
            seg[f, :, :len(s)] = np.asarray(s, np.int32).T
    (planes, seg), F = _pad_frames([planes, seg], g)
    fn = _deblock_fn(mesh, kind, planes.shape[0], B, planes.shape[1],
                     planes.shape[2], vertical, pix_max)
    out = fn(jnp.asarray(planes), *(jnp.asarray(seg[:, i])
                                    for i in range(7)))
    return np.asarray(out)[:F, :H]


def _add_fn(mesh, F, H, W, pix_max):
    key = (id(mesh), "add", F, H, W, pix_max)
    fn = _CACHE.get(key)
    if fn is None:
        def local(slab, res):
            return jnp.clip(slab + res, 0, pix_max)
        fn = jax.jit(jax.shard_map(
            local, mesh=mesh,
            in_specs=(P("gop", "tile", None), P("gop", "tile", None)),
            out_specs=P("gop", "tile", None)))
        _CACHE[key] = fn
    return fn


def residual_add_sharded(mesh, planes, res, pix_max):
    """Sharded recon residual add: planes/res [F, H, W] np.int32 ->
    clip(planes + res).  Elementwise — no halo."""
    g, t = mesh.shape["gop"], mesh.shape["tile"]
    planes, H = _pad_rows(planes, t, "constant")
    res, _ = _pad_rows(res, t, "constant")
    (planes, res), F = _pad_frames([planes, res], g)
    fn = _add_fn(mesh, planes.shape[0], planes.shape[1], planes.shape[2],
                 pix_max)
    return np.asarray(fn(jnp.asarray(planes), jnp.asarray(res)))[:F, :H]


def _lmcs_fn(mesh, F, H, W, L):
    key = (id(mesh), "lmcs", F, H, W, L)
    fn = _CACHE.get(key)
    if fn is None:
        def local(slab, lut, mask):
            return jax.vmap(lambda s, l, m: jnp.where(m, l[s], s))(
                slab, lut, mask)
        fn = jax.jit(jax.shard_map(
            local, mesh=mesh,
            in_specs=(P("gop", "tile", None), P("gop", None),
                      P("gop", "tile", None)),
            out_specs=P("gop", "tile", None)))
        _CACHE[key] = fn
    return fn


def lmcs_batch_sharded(mesh, planes, luts, masks):
    """Sharded LMCS inverse mapping: planes [F, H, W] int32, luts [F, L],
    masks [F, H, W] bool (per-CTB sh_lmcs_used gating)."""
    g, t = mesh.shape["gop"], mesh.shape["tile"]
    planes, H = _pad_rows(planes, t, "constant")
    masks, _ = _pad_rows(masks, t, "constant")
    (planes, masks), F = _pad_frames([planes, masks], g)
    luts = np.concatenate(
        [luts, np.zeros((planes.shape[0] - luts.shape[0], luts.shape[1]),
                        luts.dtype)]) if planes.shape[0] != luts.shape[0] \
        else luts
    fn = _lmcs_fn(mesh, planes.shape[0], planes.shape[1], planes.shape[2],
                  luts.shape[1])
    out = fn(jnp.asarray(planes), jnp.asarray(luts), jnp.asarray(masks))
    return np.asarray(out)[:F, :H]


def sao_batch_sharded(mesh, src, typ, m1, offs, keep, shift, pix_max):
    """Batched sharded SAO: src/typ/m1/keep [F, H, W] np.int32, offs
    [F, 5, H, W].  Frames shard over "gop", row slabs over "tile"; the
    1-row neighbour halo rides a ppermute.  Returns filtered [F, H, W]."""
    g, t = mesh.shape["gop"], mesh.shape["tile"]
    src, H = _pad_rows(src, t, "edge")
    typ, _ = _pad_rows(typ, t, "constant")
    m1, _ = _pad_rows(m1, t, "constant")
    offs, _ = _pad_rows(offs, t, "constant")
    keep, _ = _pad_rows(keep, t, "constant")
    (src, typ, m1, offs, keep), F = _pad_frames(
        [src, typ, m1, offs, keep], g)
    fn = _sao_fn(mesh, src.shape[0], src.shape[1], src.shape[2],
                 shift, pix_max)
    out = fn(jnp.asarray(src), jnp.asarray(typ), jnp.asarray(m1),
             jnp.asarray(offs), jnp.asarray(keep))
    return np.asarray(out)[:F, :H]


def alf_batch_sharded(mesh, cur, v0, v1, cf, cl, vb, pix_max):
    """Batched sharded ALF: cur/vb [F, H, W], v0/v1/cf/cl [F, 12, H, W].
    Taps are host-gathered so the pass is elementwise (no halo)."""
    g, t = mesh.shape["gop"], mesh.shape["tile"]
    cur, H = _pad_rows(cur, t, "constant")
    v0, _ = _pad_rows(v0, t, "constant")
    v1, _ = _pad_rows(v1, t, "constant")
    cf, _ = _pad_rows(cf, t, "constant")
    cl, _ = _pad_rows(cl, t, "constant")
    vb, _ = _pad_rows(vb, t, "constant")
    # zero clip bound would clamp tap diffs to 0 on padded rows — harmless
    # (cf is zero there too), but keep cl >= 1 to mirror the rasterizer
    (cur, v0, v1, cf, cl, vb), F = _pad_frames([cur, v0, v1, cf, cl, vb], g)
    fn = _alf_fn(mesh, cur.shape[0], cur.shape[1], cur.shape[2], pix_max)
    out = fn(jnp.asarray(cur), jnp.asarray(v0), jnp.asarray(v1),
             jnp.asarray(cf), jnp.asarray(cl), jnp.asarray(vb))
    return np.asarray(out)[:F, :H]


def cc_batch_sharded(mesh, dst, curl, v, cf, half, pix_max):
    """Batched sharded CC-ALF: dst/curl [F, H, W], v/cf [F, 7, H, W]."""
    g, t = mesh.shape["gop"], mesh.shape["tile"]
    dst, H = _pad_rows(dst, t, "constant")
    curl, _ = _pad_rows(curl, t, "constant")
    v, _ = _pad_rows(v, t, "constant")
    cf, _ = _pad_rows(cf, t, "constant")
    (dst, curl, v, cf), F = _pad_frames([dst, curl, v, cf], g)
    fn = _cc_fn(mesh, dst.shape[0], dst.shape[1], dst.shape[2],
                half, pix_max)
    out = fn(jnp.asarray(dst), jnp.asarray(curl), jnp.asarray(v),
             jnp.asarray(cf))
    return np.asarray(out)[:F, :H]


class MeshFilterQueue:
    """Deferred mesh pixel pipeline for decoded frames.

    Frames enqueue after recon/MC with their remaining pixel passes
    described per entry: an optional sharded residual add (inter-only
    frames), optional LMCS inverse mapping, optional deblocking (host
    segment raster, sharded filter math), then SAO / ALF / CC-ALF — all
    batched over the "gop" axis and row-slab sharded over "tile" with
    ppermute halos.  `drain(needed=...)` lands only the frames a
    subsequent inter frame actually references (the collective form of
    the reference's row-progress gating, vvc_thread.c:281-296), keeping
    non-referenced frames queued so the gop axis stays >1-deep on inter
    content."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.q = []
        self._shape_key = None

    def add(self, sps, pps, tabs, fb, sh_list, alf_list, slice_rpls=None,
            res_planes=None, lmcs_ctx=None):
        """slice_rpls: run deblock on the mesh (host raster at drain);
        res_planes: per-plane int32 residual arrays to add (recon was
        deferred); lmcs_ctx: (inv_lut np[int32], mask np[bool HxW])."""
        key = (pps.width, pps.height, sps.bit_depth,
               sps.chroma_format_idc)
        if self.q and key != self._shape_key:
            self.drain()
        self._shape_key = key
        self.q.append({"sps": sps, "pps": pps, "tabs": tabs, "fb": fb,
                       "sh_list": sh_list, "alf_list": alf_list,
                       "rpls": slice_rpls, "res": res_planes,
                       "lmcs": lmcs_ctx})

    def drain(self, needed=None):
        """Run the deferred passes.  With `needed` (a set of FrameBuffer
        objects) only those frames land; the rest stay queued."""
        if not self.q:
            return
        if needed is None:
            q, self.q = self.q, []
        else:
            q = [e for e in self.q if e["fb"] in needed]
            if not q:
                return
            self.q = [e for e in self.q if e["fb"] not in needed]
        sps = q[0]["sps"]
        pix_max0 = (1 << sps.bit_depth) - 1
        nc0 = 3 if sps.chroma_format_idc else 1

        # --- sharded residual add (deferred recon of inter-only frames) --
        for c in range(nc0):
            batch = [e for e in q if e["res"] is not None]
            if not batch:
                break
            planes = np.stack([np.asarray(e["fb"].planes[c], np.int32)
                               for e in batch])
            res = np.stack([e["res"][c] for e in batch])
            out = residual_add_sharded(self.mesh, planes, res, pix_max0)
            for k, e in enumerate(batch):
                e["fb"].planes[c][:] = out[k]

        # --- sharded LMCS inverse mapping (luma) -------------------------
        batch = [e for e in q if e["lmcs"] is not None]
        if batch:
            planes = np.stack([np.asarray(e["fb"].planes[0], np.int32)
                               for e in batch])
            luts = np.stack([np.asarray(e["lmcs"][0], np.int32)
                             for e in batch])
            masks = np.stack([e["lmcs"][1] for e in batch])
            out = lmcs_batch_sharded(self.mesh, planes, luts, masks)
            for k, e in enumerate(batch):
                e["fb"].planes[0][:] = out[k]

        # --- sharded deblocking (host segment raster, device math) ------
        batch = [e for e in q if e["rpls"] is not None]
        for vertical in (True, False):
            if not batch:
                break
            rasters = [rasterize_deblock(e["sps"], e["pps"], e["tabs"],
                                         e["fb"], e["rpls"], vertical)
                       for e in batch]
            if any(r.luma_segs for r in rasters):
                planes = np.stack([np.asarray(e["fb"].planes[0], np.int32)
                                   for e in batch])
                out = deblock_batch_sharded(
                    self.mesh, planes, [r.luma_segs for r in rasters],
                    "luma", vertical, pix_max0)
                for k, e in enumerate(batch):
                    e["fb"].planes[0][:] = out[k]
            for c in (1, 2):
                if nc0 == 1 or not any(r.chroma_segs.get(c)
                                       for r in rasters):
                    continue
                planes = np.stack([np.asarray(e["fb"].planes[c], np.int32)
                                   for e in batch])
                out = deblock_batch_sharded(
                    self.mesh, planes,
                    [r.chroma_segs.get(c) or [] for r in rasters],
                    "chroma", vertical, pix_max0)
                for k, e in enumerate(batch):
                    e["fb"].planes[c][:] = out[k]
        shift = sps.bit_depth - 5
        pix_max = (1 << sps.bit_depth) - 1
        half = 1 << (sps.bit_depth - 1)
        nc = 3 if sps.chroma_format_idc else 1
        # --- batched sharded SAO per plane component ---------------------
        from ..ops.sao_device import _rasterize_plane
        from ..sao import SaoFilter
        for c in range(nc):
            batch = []      # (entry, maps)
            for e in q:
                if not any(int(t) for t in e["tabs"].sao_type[:, c]):
                    continue
                sf = SaoFilter(e["sps"], e["pps"], e["tabs"], e["fb"])
                maps = _rasterize_plane(sf, c, e["fb"].planes[c])
                if maps is not None:
                    batch.append((e, maps))
            if not batch:
                continue
            src = np.stack([np.asarray(e["fb"].planes[c], np.int32)
                            for e, _ in batch])
            typ = np.stack([m[0] for _, m in batch])
            m1 = np.stack([m[1] for _, m in batch])
            offs = np.stack([m[2] for _, m in batch])
            keep = np.stack([m[3] for _, m in batch])
            out = sao_batch_sharded(self.mesh, src, typ, m1, offs, keep,
                                    shift, pix_max)
            for k, (e, _) in enumerate(batch):
                e["fb"].planes[c][:] = out[k]
        # --- ALF: rasterize on post-SAO pixels, then batched passes ------
        from ..ops.alf_device import _AlfRasterizer
        per_frame = []
        for e in q:
            if (not e["sps"].r.sps_alf_enabled_flag or
                    e["sh_list"] is None or
                    (not e["tabs"].alf_ctb_flag.any()
                     and not e["tabs"].alf_cc_idc.any())):
                per_frame.append(None)
                continue
            ras = _AlfRasterizer(e["sps"], e["pps"], e["tabs"], e["fb"],
                                 e["sh_list"], e["alf_list"])
            per_frame.append(ras.rasterize())
        for c in range(nc):
            batch = [(q[i], m[c]) for i, m in enumerate(per_frame)
                     if m is not None and m.get(c) is not None]
            if batch:
                out = alf_batch_sharded(
                    self.mesh,
                    np.stack([m["cur"] for _, m in batch]),
                    np.stack([m["v0"] for _, m in batch]),
                    np.stack([m["v1"] for _, m in batch]),
                    np.stack([m["cf"] for _, m in batch]),
                    np.stack([m["cl"] for _, m in batch]),
                    np.stack([m["vb"] for _, m in batch]), pix_max)
                for k, (e, _) in enumerate(batch):
                    e["fb"].planes[c][:] = out[k]
        for c in (1, 2):
            batch = [(q[i], m[("cc", c)]) for i, m in enumerate(per_frame)
                     if m is not None and m.get(("cc", c)) is not None]
            if not batch:
                continue
            out = cc_batch_sharded(
                self.mesh,
                np.stack([e["fb"].planes[c].astype(np.int32)
                          for e, _ in batch]),
                np.stack([m["curl"] for _, m in batch]),
                np.stack([m["v"] for _, m in batch]),
                np.stack([m["cf"] for _, m in batch]), half, pix_max)
            for k, (e, _) in enumerate(batch):
                e["fb"].planes[c][:] = out[k]
