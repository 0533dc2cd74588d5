"""Multi-device decode sharding over a jax.sharding.Mesh.

Axes:
  * "gop"  — frame-parallel: different frames of a GOP decode on different
    devices (the device form of the reference's 16-deep frame pipeline,
    /root/reference/libavcodec/vvc/vvcdec.c:830-841 submit/wait).
  * "tile" — spatial row-slab parallel within a frame, CTU-row aligned
    (the device form of the reference's CTU wavefront / tile parallelism,
    /root/reference/libavcodec/vvc/vvc_thread.c:41-51).

Cross-slab dataflow (deblock halos, MC reference rows) moves between
devices with jax.lax.ppermute (NCCL over NVLink on a multi-GPU host, where
every card reaches every other, so the mesh order follows the algorithm
alone) — the replacement for the reference's row-progress listeners
(/root/reference/libavcodec/vvc/vvc_refs.c:532-565).
Slab boundaries are CTU-row aligned, so a transform block (<=64px within a
128px CTU) never straddles a slab; cross-slab dependencies are confined to
the fixed small halos of the loop filters and inter MC.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P


def exchange_row_halo(slab, halo: int, n_tiles: int, axis: str = "tile"):
    """Exchange boundary row strips between vertically adjacent slabs.

    slab: [..., slab_h, W] (leading batch dims allowed).  Returns
    (above, below): `above` is the bottom `halo` rows of the slab-above
    (zeros on the top edge), `below` the top `halo` rows of the slab-below
    (zeros on the bottom edge).  One ppermute each way.
    """
    down = [(i, i + 1) for i in range(n_tiles - 1)]
    up = [(i + 1, i) for i in range(n_tiles - 1)]
    above = jax.lax.ppermute(slab[..., -halo:, :], axis, down)
    below = jax.lax.ppermute(slab[..., :halo, :], axis, up)
    return above, below


def build_sharded_sao(mesh: Mesh, frame_h: int, frame_w: int, shift: int,
                      pix_max: int):
    """Whole-frame SAO sharded into CTU-row slabs over the "tile" axis.

    The per-pixel parameter maps (see ops/sao_device.py) shard with the
    frame; the 1-pixel neighbour ring crosses slab boundaries via a single
    ppermute halo exchange (reference analogue: the sao_pixel_buffer_h/v
    line buffers of vvc_filter.c:123-152, re-expressed as a collective).
    Returns a jitted fn(src, typ, m1, offs, keep) -> filtered [H, W].
    """
    from ..ops.sao_device import _sao_math

    t = mesh.shape["tile"]
    assert frame_h % t == 0, (frame_h, t)

    def local(src, typ, m1, offs, keep):
        # src [h, W] slab; halo rows from vertical neighbours (frame edges
        # replicate the slab's own border row, matching np.pad edge mode)
        above, below = exchange_row_halo(src, 1, t)
        idx = jax.lax.axis_index("tile")
        top = jnp.where(idx == 0, src[:1], above)
        bot = jnp.where(idx == t - 1, src[-1:], below)
        tall = jnp.concatenate([top, src, bot], axis=0)      # [h+2, W]
        pad = jnp.concatenate([tall[:, :1], tall, tall[:, -1:]], axis=1)
        return _sao_math(pad, typ, m1, offs, keep, shift, pix_max)

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P("tile", None), P("tile", None), P("tile", None),
                  P(None, "tile", None), P("tile", None)),
        out_specs=P("tile", None))
    return jax.jit(fn)
