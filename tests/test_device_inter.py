"""checkasm-style equivalence: device DMVR/BDOF kernels vs the host golden
(the analogue of the reference's vvc_inter.asm SAD + BDOF units)."""
import sys
import os

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from ffvvc_jax.inter import InterPredictor
from ffvvc_jax.ops.inter_device import bdof_batch, dmvr_refine_batch


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("size", [(8, 8), (16, 8), (8, 16), (16, 16)])
def test_bdof_device_matches_golden(bd, size):
    w, h = size
    rng = np.random.default_rng(bd * 100 + w + h)
    B = 9
    # 14-bit intermediate domain with the integer-sample border ring
    s0 = rng.integers(0, 1 << 14, (B, h + 2, w + 2)).astype(np.int32)
    s1 = rng.integers(0, 1 << 14, (B, h + 2, w + 2)).astype(np.int32)
    # include near-identical pairs (vx/vy zero paths)
    s1[0] = s0[0]
    s1[1] = s0[1] + 3
    ip = InterPredictor.__new__(InterPredictor)
    ip.bd = bd
    ref = np.stack([np.asarray(ip._apply_bdof(s0[b].astype(np.int64),
                                              s1[b].astype(np.int64), w, h))
                    for b in range(B)])
    out = bdof_batch(s0, s1, bd)
    assert np.array_equal(out, ref)


class _Frames:
    def __init__(self, plane):
        self.planes = [plane]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("size", [(16, 16), (16, 8), (8, 16), (8, 8)])
def test_dmvr_refine_device_matches_golden(seed, size):
    from ffvvc_jax.mvs import MvField
    bw, bh = size
    rng = np.random.default_rng(seed * 10 + bw)
    B = 17
    ph, pw = bh + 4, bw + 4
    # 10-bit bilinear-prefetch domain; mix near-identical (early-exit /
    # skip-bdof) and divergent pairs (full search + parametric refine)
    t0 = rng.integers(0, 1 << 10, (B, ph, pw)).astype(np.int32)
    t1 = np.where(rng.random((B, 1, 1)) < 0.4, t0 + rng.integers(-2, 3),
                  rng.integers(0, 1 << 10, (B, ph, pw))).astype(np.int32)
    dmv, skip = dmvr_refine_batch(t0, t1, bw, bh)
    for b in range(B):
        ip = InterPredictor.__new__(InterPredictor)
        ip.bd = 10
        ip._mc_lib = None
        pair = [t0[b].astype(np.int64), t1[b].astype(np.int64)]
        ip._dmvr_bilinear = lambda plane, mvv, x0, y0, pw_, ph_, \
            _p=pair: _p.pop(0)
        mv = MvField()
        mv.mv = [[0, 0], [0, 0]]
        ref_skip = ip._dmvr_refine(mv, [_Frames(None), _Frames(None)],
                                   0, 0, bw, bh)
        assert (mv.mv[0][0], mv.mv[0][1]) == (int(dmv[b, 0]),
                                              int(dmv[b, 1])), b
        assert (mv.mv[1][0], mv.mv[1][1]) == (-int(dmv[b, 0]),
                                              -int(dmv[b, 1])), b
        assert bool(skip[b]) == bool(ref_skip), b
