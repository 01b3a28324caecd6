"""Device-side exact bit accounting.

The reference learns how many bits a GOB cost by asking the stream layer
after writing it (SURVEY section 3d: mwtell deltas feeding rate control).
This codec inverts this: because every H.261 symbol's VLC *length*
is a pure LUT function of the symbol, the exact size of the bitstream is
computable on device, vectorized over all MBs, without materializing a
single bit.  Rate control therefore runs inside `jit`/`lax.scan`, and the
host serializer (p64tpu.entropy.encode) must -- and is tested to -- produce
exactly `frame_bits` bits.

All sequential-looking dependencies of the MB layer (MBA gaps, the MVD
predictor chain) are computed with per-GOB exclusive-cummax + gather tricks
instead of scans, so the whole model is a handful of fused element-wise ops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..spec import luts
from ..spec.constants import (
    GBSC_BITS,
    GN_BITS,
    GQUANT_BITS,
    MBS_PER_GOB,
    PEI_BITS,
    PSC_BITS,
    PTYPE_BITS,
    TR_BITS,
    Format,
)

PICTURE_HEADER_BITS = PSC_BITS + TR_BITS + PTYPE_BITS + PEI_BITS
GOB_HEADER_BITS = GBSC_BITS + GN_BITS + GQUANT_BITS + PEI_BITS

# LUTs as module-level numpy constants; jnp.asarray inside jit is free.
# Compact VLC-entry table: every (run, |level|) outside run<=26, |level|<=15
# is the 20-bit escape, so the gatherable part is 27x16 (see _tc_len).
_TC_RUN_MAX = 26
_TC_LEV_MAX = 15
_TC_LEN_SMALL = luts.TC_LEN[:_TC_RUN_MAX + 1, :_TC_LEV_MAX + 1].astype(
    np.float32)
_TC_ESCAPE = int(luts.TC_LEN[63, 127])  # 6+6+8 = 20 bits
assert (luts.TC_LEN[_TC_RUN_MAX + 1:, 1:] == _TC_ESCAPE).all()
assert (luts.TC_LEN[:, _TC_LEV_MAX + 1:] == _TC_ESCAPE).all()
assert (luts.TC_LEN[:, 0] == 0).all()
_MBA_LEN = luts.MBA_LEN.astype(np.int32)
_MTYPE_LEN = luts.MTYPE_LEN.astype(np.int32)
_MVD_LEN = luts.MVD_LEN.astype(np.int32)
_CBP_LEN = luts.CBP_LEN.astype(np.int32)
_MTYPE_MC = luts.MTYPE_MC.astype(np.bool_)
_MTYPE_CBP = luts.MTYPE_CBP.astype(np.bool_)
_MTYPE_TCOEFF = luts.MTYPE_TCOEFF.astype(np.bool_)
_MTYPE_INTRA = luts.MTYPE_INTRA.astype(np.bool_)
_MTYPE_MQUANT = luts.MTYPE_MQUANT.astype(np.bool_)
MQUANT_BITS = 5
#: public view of the MTYPE code lengths: the encoder's MQUANT segment
#: cost model prices the MTYPE upgrade delta (core/encoder.py)
MTYPE_LEN = _MTYPE_LEN


def _sel(table: np.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Gather-free small-table lookup: one-hot select-sum (a compare +
    masked sum over a <=64-entry table is pure element-wise work)."""
    t = jnp.asarray(table, jnp.int32)
    oh = idx[..., None] == jnp.arange(t.shape[0], dtype=jnp.int32)
    return jnp.sum(jnp.where(oh, t, 0), axis=-1)


def _sel_bool(table: np.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Gather-free boolean-table lookup (see _sel)."""
    t = jnp.asarray(table, bool)
    oh = idx[..., None] == jnp.arange(t.shape[0], dtype=jnp.int32)
    return jnp.any(oh & t, axis=-1)


def _exclusive_cummax(x: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """Exclusive running max along axis, seeded with the dtype's minimum-ish
    sentinel (-1 suffices for index chains)."""
    axis = axis % x.ndim
    inc = jax.lax.cummax(x, axis=axis)
    pad = jnp.full_like(jnp.take(inc, jnp.asarray([0]), axis=axis), -1)
    return jnp.concatenate(
        [pad, jax.lax.slice_in_dim(inc, 0, x.shape[axis] - 1, axis=axis)],
        axis=axis)


def _tc_len(run: jnp.ndarray, alev: jnp.ndarray) -> jnp.ndarray:
    """TCOEFF code length per coefficient, gather-free.

    Semantically `TC_LEN[run, clip(alev, 0, 127)]`, computed without a
    per-element 2D gather: the small 27x16 VLC-entry table is applied as a
    one-hot bf16 matmul + masked select; every other (run, |level|)
    combination is the 20-bit escape and |level| == 0 costs nothing.
    Exact at any matmul precision: one-hot entries and lengths <= 20 are
    bf16-representable and the f32 sums stay below 2^21.  Checked against
    a direct gather by p64tpu.tools.parity.  (Whether a direct gather is
    faster on the GPU is open: ROADMAP S4.)
    """
    esc = (alev > _TC_LEV_MAX) | (run > _TC_RUN_MAX)
    r = jnp.clip(run, 0, _TC_RUN_MAX)
    a = jnp.clip(alev, 0, _TC_LEV_MAX)
    oh_r = (r[..., None] == jnp.arange(_TC_RUN_MAX + 1)).astype(jnp.bfloat16)
    table = jnp.asarray(_TC_LEN_SMALL, jnp.bfloat16)
    part = jax.lax.dot_general(
        oh_r, table,
        dimension_numbers=(((oh_r.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32)        # (..., 16)
    oh_a = a[..., None] == jnp.arange(_TC_LEV_MAX + 1)
    val = jnp.sum(jnp.where(oh_a, part, 0.0), axis=-1).astype(jnp.int32)
    return jnp.where(alev == 0, 0, jnp.where(esc, _TC_ESCAPE, val))


def block_bits(levels_zz: jnp.ndarray, intra: jnp.ndarray) -> jnp.ndarray:
    """Exact TCOEFF bits for each block, EXCLUDING EOB and the intra DC FLC.

    Args:
      levels_zz: (..., 64) int levels in zigzag order.
      intra: (...,) bool (ACs start at position 1, no first-coef short form).

    Returns:
      (...,) int32 sum of coefficient code lengths, with the inter
      first-coefficient (0, +/-1) short form accounted.
    """
    lv = levels_zz.astype(jnp.int32)
    p = jnp.arange(64, dtype=jnp.int32)
    start = jnp.where(intra[..., None], 1, 0)
    nz = (lv != 0) & (p >= start)
    marks = jnp.where(nz, p, -1)
    prev = jnp.maximum(_exclusive_cummax(marks), start - 1)
    run = p - prev - 1
    alev = jnp.abs(lv)
    clen = _tc_len(run, jnp.clip(alev, 0, 127))
    total = jnp.sum(jnp.where(nz, clen, 0), axis=-1)
    # inter first-coefficient short form: position 0, |level| 1 -> 2 bits
    first01 = (~intra) & (alev[..., 0] == 1)
    return total - jnp.where(first01, luts.FIRST01_SAVING, 0)


def wrap_mvd(d: jnp.ndarray) -> jnp.ndarray:
    """Fold MV - pred into -16..15 by +/-32 (matches encode.wrap_mvd)."""
    return ((d + 16) % 32) - 16


def gob_payload_bits_per_mb(codedt: jnp.ndarray, mtypet: jnp.ndarray,
                            mvt: jnp.ndarray, cbpt: jnp.ndarray,
                            levelst: jnp.ndarray) -> jnp.ndarray:
    """Exact per-MB bit cost of GOBs given transmission-ordered arrays.

    Shapes: codedt/mtypet/cbpt (..., 33); mvt (..., 33, 2);
    levelst (..., 33, 6, 64).  Returns (..., 33) int32 per-MB payload bits
    (each MB's MBA + MTYPE [+MQUANT] [+MVD] [+CBP] + blocks; GOB header
    excluded).  The MBA and MVD chains are per-GOB by construction (they
    reset at GOB boundaries), so each GOB is self-contained -- which is what
    lets per-GOB rate control run as a `lax.scan` calling this on one GOB at
    a time, and what lets mid-GOB MQUANT adaptation consume a per-segment
    prefix of these costs (control.ratecontrol / core.encoder).
    """
    idx = jnp.arange(MBS_PER_GOB, dtype=jnp.int32)
    marks = jnp.where(codedt, idx, -1)
    prev_idx = _exclusive_cummax(marks, axis=-1)           # (..., 33)
    mba = idx - prev_idx                                   # >= 1 where coded
    mba_bits = _sel(_MBA_LEN, jnp.clip(mba, 0, 33))

    mtype_bits = _sel(_MTYPE_LEN, mtypet)
    is_mc = _sel_bool(_MTYPE_MC, mtypet) & codedt
    has_cbp = _sel_bool(_MTYPE_CBP, mtypet) & codedt
    has_tc = _sel_bool(_MTYPE_TCOEFF, mtypet) & codedt
    is_intra = _sel_bool(_MTYPE_INTRA, mtypet) & codedt

    # MVD predictor: previous MB's MV iff adjacent (gap 1), previous coded
    # MB was MC, and not at the start of an MB row (idx % 11 == 0).
    safe_prev = jnp.clip(prev_idx, 0, MBS_PER_GOB - 1)
    oh_prev = safe_prev[..., None] == jnp.arange(MBS_PER_GOB,
                                                 dtype=jnp.int32)
    prev_mv = jnp.sum(jnp.where(oh_prev[..., None], mvt[..., None, :, :], 0),
                      axis=-2)                             # (..., 33, 2)
    prev_mc = jnp.any(oh_prev & is_mc[..., None, :], axis=-1)
    use_pred = (mba == 1) & prev_mc & (idx % 11 != 0) & (prev_idx >= 0)
    pred = jnp.where(use_pred[..., None], prev_mv, 0)
    mvd = wrap_mvd(mvt - pred)
    mvd_bits = _sel(_MVD_LEN, mvd + 16).sum(axis=-1)

    cbp_bits = _sel(_CBP_LEN, jnp.clip(cbpt, 0, 63))

    # per-block coefficient bits + EOB + intra DC FLC
    bb = block_bits(levelst, is_intra[..., None])          # (..., 33, 6)
    blk_sent = jnp.where(is_intra[..., None], True,
                         (levelst != 0).any(axis=-1)) & has_tc[..., None]
    blk_bits = jnp.where(blk_sent,
                         bb + luts.EOB_LEN + jnp.where(is_intra[..., None],
                                                       8, 0),
                         0).sum(axis=-1)

    has_mq = _sel_bool(_MTYPE_MQUANT, mtypet) & codedt

    mb_bits = jnp.where(
        codedt,
        mba_bits + mtype_bits
        + jnp.where(has_mq, MQUANT_BITS, 0)
        + jnp.where(is_mc, mvd_bits, 0)
        + jnp.where(has_cbp, cbp_bits, 0)
        + blk_bits,
        0)
    return mb_bits.astype(jnp.int32)


def gob_payload_bits(codedt: jnp.ndarray, mtypet: jnp.ndarray,
                     mvt: jnp.ndarray, cbpt: jnp.ndarray,
                     levelst: jnp.ndarray) -> jnp.ndarray:
    """Exact MB-layer bits of GOBs (sum of gob_payload_bits_per_mb)."""
    return gob_payload_bits_per_mb(
        codedt, mtypet, mvt, cbpt, levelst).sum(axis=-1).astype(jnp.int32)


def to_transmission(fmt: Format, coded, mtype, mv, cbp, levels):
    """Reorder raster-MB-order arrays into (nGOB, 33, ...) transmission
    order for the per-GOB bit model (pure layout transform, gather-free)."""
    from ..core.blocks import to_gob_order
    return (to_gob_order(fmt, coded), to_gob_order(fmt, mtype),
            to_gob_order(fmt, mv), to_gob_order(fmt, cbp),
            to_gob_order(fmt, levels))


def frame_bits(fmt: Format,
               coded: jnp.ndarray,
               mtype: jnp.ndarray,
               mv: jnp.ndarray,
               cbp: jnp.ndarray,
               levels: jnp.ndarray):
    """Exact bit cost of one coded picture (raster-MB-order inputs).

    Returns:
      (total_bits, gob_bits): int32 scalar and (nGOB,) int32 vector
      (gob_bits includes each GOB's header).
    """
    codedt, mtypet, mvt, cbpt, levelst = to_transmission(
        fmt, coded, mtype, mv, cbp, levels)
    gob_bits = (gob_payload_bits(codedt, mtypet, mvt, cbpt, levelst)
                + GOB_HEADER_BITS)
    total = gob_bits.sum() + PICTURE_HEADER_BITS
    return total.astype(jnp.int32), gob_bits.astype(jnp.int32)
