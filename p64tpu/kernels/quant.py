"""Quantization / inverse quantization and zigzag, batched over blocks.

Normative behavior is H.261 section 4.2.4 ([SPEC]): step size 2*QUANT with a
dead zone for all coefficients except the intra DC, which uses a uniform
step-8 quantizer and an 8-bit FLC.  The reference folds this into its
per-block encode path (SURVEY section 2: transform/quant stage, location
unverified -- mount empty this round).  Encoder-side *choices* documented
here (division rounding of the forward quantizer) are ours and centralized
for recalibration against the reference:

  forward AC/inter:  level = trunc_toward_zero(coef / (2*QUANT)), clamped to
                     +/-127 (the escape-codeable range)
  forward intra DC:  level = clamp((coef + 4) >> 3, 1, 254)

Inverse (normative, H.261 section 4.2.4.1/4.2.4.2):

  level == 0            -> 0
  level > 0, QUANT odd  -> QUANT*(2*level+1)
  level > 0, QUANT even -> QUANT*(2*level+1) - 1
  level < 0             -> mirrored (+1 on even QUANT)
  clamp to [-2048, 2047];  intra DC -> 8*level (level 128 via code 255)
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..spec.constants import (
    COEFF_CLAMP_MAX,
    COEFF_CLAMP_MIN,
    INTRA_DC_MAX,
    INTRA_DC_MIN,
    LEVEL_CLAMP,
)
from ..spec.zigzag import INV_ZIGZAG, ZIGZAG


def zigzag_scan(blocks: jnp.ndarray) -> jnp.ndarray:
    """(..., 8, 8) -> (..., 64) in zigzag transmission order."""
    flat = blocks.reshape(*blocks.shape[:-2], 64)
    return flat[..., jnp.asarray(ZIGZAG)]


def zigzag_unscan(zz: jnp.ndarray) -> jnp.ndarray:
    """(..., 64) zigzag order -> (..., 8, 8) row-major."""
    flat = zz[..., jnp.asarray(INV_ZIGZAG)]
    return flat.reshape(*zz.shape[:-1], 8, 8)


#: magic multipliers for exact division by 2*QUANT without an integer
#: divide (XLA lowers `//` to a multi-op sequence):
#: x // d == (x * M[d]) >> 17 with M[d] = 2^17 // d + 1 EXACTLY for all
#: x in [0, 2047], d in [1, 62] (exhaustively verified in
#: tests/test_kernels.py::test_quantize_magic_division_domain); products
#: stay < 2^28, int32-safe.
_DIV_K = 17
_DIV_MAGIC = np.zeros(63, np.int32)
_DIV_MAGIC[1:] = (1 << _DIV_K) // np.arange(1, 63) + 1


def _magic_for(q2: jnp.ndarray) -> jnp.ndarray:
    """Gather-free M[q2] lookup (one-hot select over the tiny table; q2 is
    per-MB at most, so this is negligible next to the coefficient tensor)."""
    oh = q2[..., None] == jnp.arange(63, dtype=jnp.int32)
    return jnp.sum(jnp.where(oh, jnp.asarray(_DIV_MAGIC), 0), axis=-1)


def quantize(coefs: jnp.ndarray, quant: jnp.ndarray,
             intra: jnp.ndarray) -> jnp.ndarray:
    """Quantize DCT coefficients.

    Args:
      coefs: (..., 8, 8) int32 transform coefficients.
      quant: broadcastable integer QUANT (1..31), e.g. (..., 1, 1).
      intra: broadcastable boolean; where True the DC (position [...,0,0])
        uses the intra-DC rule.

    Returns:
      (..., 64) int32 zigzag-ordered levels (intra DC level in slot 0).
    """
    coefs = coefs.astype(jnp.int32)
    q2 = (2 * jnp.asarray(quant)).astype(jnp.int32)
    m = _magic_for(q2)
    # trunc-toward-zero division by 2*QUANT via exact magic multiply (see
    # _DIV_MAGIC); |coefs| <= 2047 is guaranteed by the forward DCT bound
    # (kernels/dct.py) and is the verified domain of the trick.
    av = jnp.abs(coefs)
    ac = jnp.sign(coefs) * ((av * m) >> _DIV_K)
    ac = jnp.clip(ac, -LEVEL_CLAMP, LEVEL_CLAMP)
    dc_intra = jnp.clip((coefs + 4) >> 3, INTRA_DC_MIN, INTRA_DC_MAX)
    dc_mask = jnp.zeros((8, 8), dtype=bool).at[0, 0].set(True)
    out = jnp.where(jnp.logical_and(intra, dc_mask), dc_intra, ac)
    return zigzag_scan(out)


def quantize_zz(coefs_zz: jnp.ndarray, quant: jnp.ndarray,
                intra: jnp.ndarray) -> jnp.ndarray:
    """Quantize ZIGZAG-ordered DCT coefficients (the fdct8x8_zz pipeline:
    no permutation needed -- the intra DC is already slot 0).

    Args:
      coefs_zz: (..., 64) int32 zigzag-ordered transform coefficients.
      quant: broadcastable integer QUANT (1..31), e.g. (..., 1).
      intra: broadcastable boolean against (..., 64).

    Returns (..., 64) int32 zigzag levels -- identical to
    quantize(zigzag_unscan(coefs_zz), ...)."""
    coefs = coefs_zz.astype(jnp.int32)
    q2 = (2 * jnp.asarray(quant)).astype(jnp.int32)
    m = _magic_for(q2)
    av = jnp.abs(coefs)
    ac = jnp.sign(coefs) * ((av * m) >> _DIV_K)
    ac = jnp.clip(ac, -LEVEL_CLAMP, LEVEL_CLAMP)
    dc_intra = jnp.clip((coefs + 4) >> 3, INTRA_DC_MIN, INTRA_DC_MAX)
    slot0 = jnp.zeros(64, dtype=bool).at[0].set(True)
    return jnp.where(jnp.logical_and(intra, slot0), dc_intra, ac)


def dequantize(levels_zz: jnp.ndarray, quant: jnp.ndarray,
               intra: jnp.ndarray) -> jnp.ndarray:
    """Inverse of :func:`quantize`: (..., 64) zigzag levels -> (..., 8, 8)
    reconstructed coefficients (int32, clamped).  `quant`/`intra` broadcast
    as (..., 1) against the zigzag axis."""
    lv = levels_zz.astype(jnp.int32)
    q = jnp.broadcast_to(jnp.asarray(quant, dtype=jnp.int32), lv.shape)
    s = jnp.sign(lv)
    even_adj = jnp.where(q % 2 == 0, s, 0)
    rec = jnp.where(lv == 0, 0, q * (2 * lv + s) - even_adj)
    rec = jnp.clip(rec, COEFF_CLAMP_MIN, COEFF_CLAMP_MAX)
    # intra DC: slot 0 of the zigzag vector, uniform step 8, no clamp to
    # [-2048,2047] needed (8*254 = 2032 is in range anyway).
    dc = 8 * lv[..., :1]
    slot0 = jnp.zeros(lv.shape[-1], dtype=bool).at[0].set(True)
    rec = jnp.where(jnp.logical_and(intra, slot0), dc, rec)
    return zigzag_unscan(rec)


# numpy mirrors for host-side tests/tools ----------------------------------


def np_dequantize(levels_zz: np.ndarray, quant, intra) -> np.ndarray:
    lv = np.asarray(levels_zz, dtype=np.int64)
    q = np.broadcast_to(np.asarray(quant, dtype=np.int64), lv.shape)
    s = np.sign(lv)
    even_adj = np.where(q % 2 == 0, s, 0)
    rec = np.where(lv == 0, 0, q * (2 * lv + s) - even_adj)
    rec = np.clip(rec, COEFF_CLAMP_MIN, COEFF_CLAMP_MAX)
    intra_b = np.broadcast_to(np.asarray(intra, dtype=bool), lv.shape[:-1])
    rec[..., 0] = np.where(intra_b, 8 * lv[..., 0], rec[..., 0])
    flat = np.zeros_like(rec)
    flat[..., ZIGZAG] = rec
    return flat.reshape(*lv.shape[:-1], 8, 8).astype(np.int32)
