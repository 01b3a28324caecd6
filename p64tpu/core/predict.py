"""Motion-compensated prediction, batched over macroblocks.

Reference behavior: per-MB prediction fetch from the old frame store with
optional loop filtering (SURVEY section 3a; p64.c/io.c, unverified -- mount
empty).  Here: one gather per plane builds all MB predictions at once
from index grids; the loop filter runs as a batched 8x8 kernel on the
selected MBs.

Conventions:
  * mv = (mvx, mvy); positive x is right, positive y is down ([SPEC]).
  * chroma vectors are the luma vector halved with truncation toward zero
    ([SPEC] H.261 section 3.2.2).
  * MVs never point outside the picture (guaranteed by the ME window clip),
    so the gathers need no edge clamping; indices are asserted in tests.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..spec.constants import BLOCK_SIZE, MB_SIZE, Format
from .blocks import mb_to_yblocks, yblocks_to_mb
from ..kernels.filter import loop_filter8x8


def _gather_tiles(plane: jnp.ndarray, y0: jnp.ndarray, x0: jnp.ndarray,
                  tile: int) -> jnp.ndarray:
    """plane (H, W), per-tile top-left (n,), -> (n, tile, tile)."""
    ar = jnp.arange(tile, dtype=jnp.int32)
    rows = y0[:, None] + ar[None, :]          # (n, tile)
    cols = x0[:, None] + ar[None, :]
    return plane[rows[:, :, None], cols[:, None, :]]


def _halve_mv(v: jnp.ndarray) -> jnp.ndarray:
    """Truncate-toward-zero halving for chroma vectors."""
    return jnp.sign(v) * (jnp.abs(v) // 2)


def _barrel_select(acc: jnp.ndarray, off: jnp.ndarray, bits: list,
                   tile: int, axis: int) -> jnp.ndarray:
    """Per-MB displacement select as a log-depth barrel shifter.

    acc:  (nMB, rows, cols) candidate windows; the window axis `axis` has
          width >= tile + sum(bits).
    off:  (nMB,) displacement in [0, sum(bits)] -- constant per MB, which is
          what makes shift composition valid (every intermediate element of
          an MB's window is shifted by the same applied-bit prefix).
    Returns acc narrowed to `tile` along `axis`, element j = input[j + off].

    Rationale: the previous formulation selected among 2*search+1
    statically shifted copies with a sequential `where` chain -- 31 full
    passes over the candidate buffer per axis.  Decomposing the offset into
    its binary digits needs only ceil(log2(search*2+1)) conditional-slice
    passes (5 for +/-15), and every slice is static so XLA fuses the whole
    thing.  Pure integer selects: bit-exact by construction.
    """
    rem = sum(bits)
    for b in bits:
        rem -= b
        wnext = tile + rem
        hi = jax.lax.slice_in_dim(acc, b, b + wnext, axis=axis)
        lo = jax.lax.slice_in_dim(acc, 0, wnext, axis=axis)
        shape = [1] * acc.ndim
        shape[0] = -1
        cond = ((off & b) != 0).reshape(shape)
        acc = jnp.where(cond, hi, lo)
    return acc


def _bits_for(maxoff: int) -> list:
    """Largest-first powers of two whose sum covers maxoff."""
    bits, b = [], 1 << 30
    while b >= 1:
        if b <= maxoff:
            bits.append(b)
        b >>= 1
    return bits


def _predict_mbs_barrel(plane: jnp.ndarray, mvx_mb: jnp.ndarray,
                        mvy_mb: jnp.ndarray, mb_rows: int, mb_cols: int,
                        tile: int, search: int) -> jnp.ndarray:
    """MC prediction straight into MB-tile layout (nMB, tile, tile).

    Builds per-MB candidate windows with static slices + reshapes only
    (tile-aligned: padding the plane by `search` puts window starts exactly
    at tile boundaries), then resolves the per-MB displacement with two
    barrel-shift selects (rows, then columns).  Bit-exact integer selects;
    tested against mc_predict_gather.
    """
    t = tile
    bits = _bits_for(2 * search)
    span = t + sum(bits)                     # window width the barrel needs
    ntr = mb_rows + 2                        # row tiles after padding
    ntc = mb_cols + 2
    pad = jnp.pad(plane.astype(jnp.int16),
                  ((search, ntr * t - mb_rows * t - search),
                   (search, ntc * t - mb_cols * t - search)))
    # row strips: window r covers padded rows [t*r, t*r + span) -- built
    # from 3 tile-aligned static slices, no gathers.
    rt = pad.reshape(ntr, t, ntc * t)
    strips = jnp.concatenate([rt[0:mb_rows], rt[1:mb_rows + 1],
                              rt[2:mb_rows + 2]], axis=1)  # (R, 3t, W)
    ct = strips.reshape(mb_rows, 3 * t, ntc, t)
    win = jnp.concatenate([ct[:, :, 0:mb_cols], ct[:, :, 1:mb_cols + 1],
                           ct[:, :, 2:mb_cols + 2]],
                          axis=-1)                     # (R, 3t, C, 3t)
    win = win.transpose(0, 2, 1, 3).reshape(mb_rows * mb_cols, 3 * t, 3 * t)
    assert 3 * t >= span, (t, search)
    oy = mvy_mb + search
    ox = mvx_mb + search
    win = _barrel_select(win, oy, bits, t, axis=1)     # (nMB, t, 3t)
    win = _barrel_select(win, ox, bits, t, axis=2)     # (nMB, t, t)
    return win.astype(jnp.int32)


def mc_predict(ref_y: jnp.ndarray, ref_cb: jnp.ndarray, ref_cr: jnp.ndarray,
               mv: jnp.ndarray, fil: jnp.ndarray, fmt: Format):
    """Build per-MB predictions from the reference frame (gather-free;
    see _predict_mbs_barrel for the rationale).

    Args:
      ref_y / ref_cb / ref_cr: reference planes (H,W), (H/2,W/2), (H/2,W/2).
      mv:  (nMB, 2) int32 (mvx, mvy), raster MB order; pass zeros for
           non-MC macroblocks.
      fil: (nMB,) bool -- apply the loop filter to this MB's prediction;
           None skips the filter stage entirely (the encoder's decision pass
           wants raw MC predictions and applies the filter itself later).

    Returns:
      (pred_y_mbs (nMB,16,16), pred_cb (nMB,8,8), pred_cr (nMB,8,8)) int32.
    """
    pred_y = _predict_mbs_barrel(
        ref_y, mv[:, 0], mv[:, 1], fmt.mb_rows, fmt.mb_cols, MB_SIZE, 15)

    cmv = _halve_mv(mv)
    pred_cb = _predict_mbs_barrel(
        ref_cb, cmv[:, 0], cmv[:, 1], fmt.mb_rows, fmt.mb_cols, BLOCK_SIZE,
        7)
    pred_cr = _predict_mbs_barrel(
        ref_cr, cmv[:, 0], cmv[:, 1], fmt.mb_rows, fmt.mb_cols, BLOCK_SIZE,
        7)

    if fil is None:
        return pred_y, pred_cb, pred_cr
    return _apply_filter(pred_y, pred_cb, pred_cr, fil)


def _apply_filter(pred_y, pred_cb, pred_cr, fil):
    # Loop filter: luma as four 8x8 quadrant blocks, chroma per block.
    f = fil[:, None, None]
    yb = mb_to_yblocks(pred_y)
    yb = jnp.where(f[:, None], loop_filter8x8(yb), yb)
    pred_y = yblocks_to_mb(yb)
    pred_cb = jnp.where(f, loop_filter8x8(pred_cb), pred_cb)
    pred_cr = jnp.where(f, loop_filter8x8(pred_cr), pred_cr)
    return pred_y, pred_cb, pred_cr


def mc_predict_gather(ref_y: jnp.ndarray, ref_cb: jnp.ndarray,
                      ref_cr: jnp.ndarray, mv: jnp.ndarray,
                      fil: jnp.ndarray, fmt: Format):
    """Reference implementation of mc_predict via per-MB window gathers
    (kept as the oracle for the select-based production path)."""
    n_mb = fmt.num_mbs
    mbc = fmt.mb_cols
    idx = jnp.arange(n_mb, dtype=jnp.int32)
    y0 = (idx // mbc) * MB_SIZE + mv[:, 1]
    x0 = (idx % mbc) * MB_SIZE + mv[:, 0]
    pred_y = _gather_tiles(ref_y.astype(jnp.int32), y0, x0, MB_SIZE)

    cmv = _halve_mv(mv)
    cy0 = (idx // mbc) * BLOCK_SIZE + cmv[:, 1]
    cx0 = (idx % mbc) * BLOCK_SIZE + cmv[:, 0]
    pred_cb = _gather_tiles(ref_cb.astype(jnp.int32), cy0, cx0, BLOCK_SIZE)
    pred_cr = _gather_tiles(ref_cr.astype(jnp.int32), cy0, cx0, BLOCK_SIZE)
    return _apply_filter(pred_y, pred_cb, pred_cr, fil)
