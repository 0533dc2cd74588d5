"""Device LMCS inverse mapping: per-CTB gated LUT gather on device.

Whole-frame form of the reference's LMCS filter stage
(/root/reference/libavcodec/vvc/vvc_filter.c:1322 ff_vvc_lmcs_filter and
the LUT apply of vvc_filter_template.c:25): the inverse-mapping LUT is a
[1 << bd] gather, gated per CTB by the owning slice's sh_lmcs_used_flag.
The host rasterizes the gate into a per-pixel mask and one jitted pass
maps the whole luma plane.  Bit-exact vs the host LUT loop by
construction (same table, same gather); pinned by
tests/test_device_filters.py."""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=())
def _lmcs_map(plane, lut, mask):
    return jnp.where(mask, lut[plane], plane)


def lmcs_frame_device(sps, pps, fb, lmcs, recon_jobs):
    """Apply the LMCS inverse mapping to the luma plane on device.
    recon_jobs carry the per-slice lmcs_used gates (decoder pixel stage)."""
    used = np.zeros((pps.ctb_height, pps.ctb_width), bool)
    any_used = False
    for rec, ctus in recon_jobs:
        if not rec.lmcs_used:
            continue
        any_used = True
        for rs, rx, ry in ctus:
            used[ry, rx] = True
    if not any_used:
        return
    plane = fb.planes[0]
    H, W = plane.shape
    ctb = sps.ctb_size_y
    mask = np.zeros((H, W), bool)
    for ry, rx in zip(*np.nonzero(used)):
        y0, x0 = ry * ctb, rx * ctb
        mask[y0:min(y0 + ctb, H), x0:min(x0 + ctb, W)] = True
    out = _lmcs_map(jnp.asarray(plane),
                    jnp.asarray(np.asarray(lmcs.inv_lut, np.int32)),
                    jnp.asarray(mask))
    plane[:] = np.asarray(out)
