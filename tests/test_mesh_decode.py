"""Real decode on a multi-device mesh must equal single-device decode.

The device-mesh counterpart of the reference's threading determinism check
(CI decodes conformance streams with --threads 4 vs 1 and compares
framecrcs, makefile.yml:20-21): here the same bitstream decodes on a
(gop, tile) jax mesh — frames batched over "gop", CTU-row slabs over
"tile" with ppermute halo exchange — and must match the host decode
byte-for-byte.  Runs on the virtual 8-device CPU mesh (conftest)."""
import sys
import os

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from ffvvc_jax.decoder import VVCDecoder
from ffvvc_jax.config import DecoderConfig

FILTER_TOOLS = dict(sps_sao_enabled_flag=1, sps_alf_enabled_flag=1,
                    sps_ccalf_enabled_flag=1, sps_lmcs_enabled_flag=1)


def _decode_both(stream, mesh_shape):
    host = VVCDecoder(DecoderConfig()).decode(stream)
    sharded = VVCDecoder(DecoderConfig(mesh_shape=mesh_shape)).decode(stream)
    assert len(host) == len(sharded) and host
    a = b"".join(f.to_yuv_bytes() for f in host)
    b = b"".join(f.to_yuv_bytes() for f in sharded)
    assert a == b, f"mesh {mesh_shape} decode differs from single-device"


@pytest.mark.parametrize("mesh_shape", [(2, 4), (1, 8), (4, 2), (8, 1)])
def test_allintra_mesh(mesh_shape):
    """All-intra frames batch over the full gop axis in one drain."""
    from forge import forge_inter_stream
    s = forge_inter_stream(slice_type=2, nframes=4, width=96, height=96,
                           seed=3, deblock=True, **FILTER_TOOLS)
    _decode_both(s, mesh_shape)


@pytest.mark.parametrize("slice_type,mesh_shape", [(0, (2, 2)), (1, (1, 4))])
def test_inter_mesh(slice_type, mesh_shape):
    """Inter frames drain per frame at the MC reference barrier."""
    from forge import forge_inter_stream
    s = forge_inter_stream(slice_type=slice_type, nframes=4, width=96,
                           height=64, seed=1, deblock=True, **FILTER_TOOLS)
    _decode_both(s, mesh_shape)


def test_mixed_rap_segments_mesh():
    """IDR-separated segments: drains happen at barriers mid-stream and at
    the end of the decode call; output must stay byte-identical."""
    from forge import forge_inter_stream
    a = forge_inter_stream(slice_type=2, nframes=2, width=64, height=64,
                           seed=5, deblock=True, **FILTER_TOOLS)
    b = forge_inter_stream(slice_type=1, nframes=3, width=64, height=64,
                           seed=6, deblock=True, **FILTER_TOOLS)
    _decode_both(a + b, (2, 4))


def test_odd_height_mesh():
    """Frame rows not divisible by the tile axis: slab padding must stay
    bit-exact (edge-replicated pixels, zero parameter maps)."""
    from forge import forge_inter_stream
    s = forge_inter_stream(slice_type=2, nframes=2, width=64, height=80,
                           seed=2, deblock=True, **FILTER_TOOLS)
    _decode_both(s, (1, 8))


def test_inter_only_defer_and_gop_depth():
    """Sharded recon residual-add + deblock for inter-only frames, and the
    RPL-aware selective drain: non-referenced B frames stay queued across
    inter reference barriers, so the final drain batches >1 frame over the
    gop axis (the collective analogue of the reference's row-progress
    gating, vvc_thread.c:281-296)."""
    import forge as F
    from ffvvc_jax.parallel import filters as PF

    class InterOnly(F.FuzzPolicy):
        """No intra / CIIP CUs in inter frames -> residual-add defers."""
        def __call__(self, tag, **ctx):
            if tag in ("pred_mode_flag", "ciip_flag"):
                return 0
            return super().__call__(tag, **ctx)

    SLICE_B, SLICE_P = 0, 1
    # min CU 8x8 / one MTT level: 4x4 CUs are forced intra by the spec
    # (no inter 4x4), which would disqualify the frame from deferral
    sps_r = F.build_sps(96, 96, bit_depth=10, min_qt_log2=3,
                        max_mtt_depth=1, sps_sao_enabled_flag=1)
    pps_r = F.build_pps(sps_r)
    stream = F.write_nal(F.NalType.SPS, F.write_sps(sps_r))
    stream += F.write_nal(F.NalType.PPS, F.write_pps(pps_r, sps_r))
    policy = InterOnly(7)
    for poc, st, rd in ((0, None, None), (2, SLICE_P, ([-2], [])),
                        (1, SLICE_B, ([-1], [1])), (4, SLICE_P, ([-2], [])),
                        (3, SLICE_B, ([-1], [1]))):
        nal, _ = F.forge_frame(sps_r, pps_r, policy, qp=32, poc=poc,
                               idr=st is None,
                               slice_type=2 if st is None else st,
                               ref_deltas=rd)
        stream += nal

    host = VVCDecoder(DecoderConfig()).decode(stream)

    log = {"res_adds": 0, "final_batch": 0, "drains": []}
    orig_add = PF.MeshFilterQueue.add
    orig_drain = PF.MeshFilterQueue.drain

    def spy_add(self, *a, **kw):
        if kw.get("res_planes") is not None:
            log["res_adds"] += 1
        return orig_add(self, *a, **kw)

    def spy_drain(self, needed=None):
        log["drains"].append((len(self.q), None if needed is None
                              else len(needed)))
        if needed is None and self.q:
            log["final_batch"] = max(log["final_batch"], len(self.q))
        return orig_drain(self, needed)

    PF.MeshFilterQueue.add = spy_add
    PF.MeshFilterQueue.drain = spy_drain
    try:
        sharded = VVCDecoder(DecoderConfig(mesh_shape=(2, 4))) \
            .decode(stream)
    finally:
        PF.MeshFilterQueue.add = orig_add
        PF.MeshFilterQueue.drain = orig_drain

    a = b"".join(f.to_yuv_bytes() for f in host)
    b = b"".join(f.to_yuv_bytes() for f in sharded)
    assert a == b, "mesh decode differs from single-device"
    # all 4 inter frames ran the deferred (sharded) residual add
    assert log["res_adds"] == 4, log
    # the end-of-decode drain batched >1 frame over the gop axis: the
    # non-referenced B frames were never forced out at a barrier
    assert log["final_batch"] >= 2, log


def test_large_ctu_mesh():
    """CTU-128 frames on the mesh: slab padding, deblock halos and ALF
    virtual boundaries at the largest CTB size."""
    from forge import forge_inter_stream
    s = forge_inter_stream(slice_type=1, nframes=2, width=256, height=256,
                           seed=2, deblock=True, ctu_log2=7,
                           sps_max_luma_transform_size_64_flag=1,
                           **FILTER_TOOLS)
    _decode_both(s, (2, 4))


def test_mesh_sharded_mc():
    """Round-5 (VERDICT r4 item 3): device MC's put batches shard over
    the mesh "tile" axis (refs replicated, batch partitioned) — an inter
    frame's MC runs on all devices, byte-exact, with per-bucket fallback
    for batches smaller than the axis."""
    from forge import forge_inter_stream, forge_hier_stream
    from ffvvc_jax.ops import mc_device
    # no chroma LMCS here: chroma residual scaling forces the Python MC
    # path (native_recon_ok gating), which has no device MC to shard
    for s in (forge_inter_stream(slice_type=0, nframes=4, width=96,
                                 height=64, seed=1, deblock=True,
                                 sps_sao_enabled_flag=1,
                                 sps_alf_enabled_flag=1),
              forge_hier_stream(seed=2, width=96, height=64, qp=32,
                                ngops=2, deblock=True,
                                sps_temporal_mvp_enabled_flag=1,
                                sps_dmvr_enabled_flag=1,
                                sps_bdof_enabled_flag=1)):
        host = VVCDecoder(DecoderConfig()).decode(s)
        before = mc_device.sharded_puts
        sharded = VVCDecoder(DecoderConfig(mesh_shape=(2, 2),
                                           device_mc=True)).decode(s)
        assert mc_device.sharded_puts > before, "no sharded put engaged"
        a = b"".join(f.to_yuv_bytes() for f in host)
        b = b"".join(f.to_yuv_bytes() for f in sharded)
        assert a == b, "mesh-sharded MC decode differs"
