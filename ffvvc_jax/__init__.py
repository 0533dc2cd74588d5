"""ffvvc_jax — a VVC (H.266) decode engine with a JAX device path.

A brand-new implementation of the capabilities of FFmpeg's native VVC decoder
(reference: /root/reference/libavcodec/vvc/), architected for an
accelerator:

  * host front-end: Annex-B NAL parsing, H.266 header syntax, CABAC entropy
    decode (incl. dependent quantization), coding-tree parse, MV derivation —
    emitting dense per-frame tensors (coefficients, mode maps, MV fields,
    filter parameters);
  * device back-end: batched JAX/XLA kernels for intra prediction
    (angular/planar/DC/MIP/CCLM), inter prediction (8-tap MC, affine+PROF,
    DMVR, BDOF, GPM) and the in-loop filter chain (deblocking, SAO,
    ALF/CC-ALF, LMCS);
  * scale-out: CTU/tile sharding within a frame, frame/GOP pipelining across
    hosts over a jax.sharding.Mesh.

Decoded output is bit-exact against the reference decoder.
"""

__version__ = "0.1.0"

from .config import DecoderConfig  # noqa: F401
