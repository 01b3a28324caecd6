"""Shared reconstruction path: levels -> dequant -> IDCT -> + prediction -> clip.

This single implementation is used both by the encoder's local decode (the
"encoder contains the decoder" property, SURVEY section 3a) and by the
decoder proper, which makes encoder-side reconstruction and decoder output
bit-identical by construction -- the batched replacement for the
reference's shared ChenIDct/dequant routines (unverified, mount empty).

Uniform per-MB formula (covers coded/uncoded/intra/inter/MC/no-coeff):

  base  = 0                      for intra-coded MBs
        = MC (optionally filtered) prediction for coded inter MBs
        = zero-MV unfiltered copy of the reference for uncoded MBs
  recon = clip(base + IDCT(dequant(levels)), 0, 255)

Uncoded and no-coefficient MBs simply carry all-zero levels (integer IDCT of
zeros is exactly zero).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..kernels.dct import idct8x8
from ..kernels.quant import dequantize
from ..spec.constants import Format
from .blocks import mbs_to_luma, tiles_to_plane, yblocks_to_mb
from .predict import mc_predict


def reconstruct_frame(fmt: Format,
                      levels: jnp.ndarray,
                      quant_mb: jnp.ndarray,
                      intra_mb: jnp.ndarray,
                      mv: jnp.ndarray,
                      fil: jnp.ndarray,
                      ref_y: jnp.ndarray,
                      ref_cb: jnp.ndarray,
                      ref_cr: jnp.ndarray,
                      pred: tuple | None = None):
    """Reconstruct full planes.

    Args:
      levels:   (nMB, 6, 64) int zigzag levels (zeros where not transmitted).
      quant_mb: (nMB,) effective QUANT per MB.
      intra_mb: (nMB,) bool.
      mv:       (nMB, 2) (mvx, mvy); zeros for non-MC and uncoded MBs.
      fil:      (nMB,) bool loop-filter flag (False for uncoded MBs).
      ref_*:    previous reconstructed planes (uint8/int).
      pred:     optional precomputed (pred_y, pred_cb, pred_cr) exactly equal
                to mc_predict(ref_*, mv, fil) -- the encoder passes its
                already-built prediction here so the (expensive) MC select
                sweep runs once per frame instead of twice; the decoder
                leaves it None.  Equality is guaranteed by construction in
                core.encoder (tested: encoder recon == decoder recon).

    Returns:
      (y, cb, cr) uint8 planes.
    """
    if pred is None:
        pred = mc_predict(ref_y, ref_cb, ref_cr, mv, fil, fmt)
    pred_y, pred_cb, pred_cr = pred

    coefs = dequantize(levels, quant_mb[:, None, None].astype(jnp.int32),
                       intra_mb[:, None, None])
    res = idct8x8(coefs)  # (nMB, 6, 8, 8)

    intra3 = intra_mb[:, None, None]
    y_mb = jnp.clip(jnp.where(intra3, 0, pred_y)
                    + yblocks_to_mb(res[:, :4]), 0, 255)
    cb_b = jnp.clip(jnp.where(intra3, 0, pred_cb) + res[:, 4], 0, 255)
    cr_b = jnp.clip(jnp.where(intra3, 0, pred_cr) + res[:, 5], 0, 255)

    y = mbs_to_luma(y_mb, fmt.height, fmt.width).astype(jnp.uint8)
    cb = tiles_to_plane(cb_b, fmt.chroma_height, fmt.chroma_width, 8
                        ).astype(jnp.uint8)
    cr = tiles_to_plane(cr_b, fmt.chroma_height, fmt.chroma_width, 8
                        ).astype(jnp.uint8)
    return y, cb, cr
