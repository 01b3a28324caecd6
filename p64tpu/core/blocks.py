"""Frame <-> macroblock/block tensor layout and H.261 transmission order.

The reference walks macroblocks with nested scalar loops (SURVEY section 3a:
p64EncodeFrame -> per GOB -> per MB; mount empty this round, unverified).
This codec instead keeps whole frames as dense arrays and reshapes them
into batched block tensors once per frame:

  luma  (H, W)        -> (nMB, 16, 16)   raster MB order
  luma  (H, W)        -> (nMB, 4, 8, 8)  the four Y blocks per MB, in H.261
                                          block order Y1 Y2 Y3 Y4
  chroma(H/2, W/2)    -> (nMB, 8, 8)

Raster MB order (row-major over the MB grid) is the device-native layout;
`transmission_order` gives the permutation into GOB-major bitstream order
for the host serializer (H.261 Figures 8/9: CIF GOBs tile 2 wide x 6 tall,
each GOB is 11 x 3 MBs).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..spec.constants import (
    BLOCK_SIZE,
    GOB_MB_COLS,
    GOB_MB_ROWS,
    MB_SIZE,
    Format,
)


def transmission_order(fmt: Format) -> np.ndarray:
    """perm[k] = raster MB index of the k-th transmitted MB (GOB-major:
    GOBs in GN order, MBA 1..33 raster within each GOB)."""
    perm = []
    gob_grid_cols = fmt.gob_cols
    for gi in range(fmt.num_gobs):
        grow, gcol = divmod(gi, gob_grid_cols)
        for idx in range(GOB_MB_ROWS * GOB_MB_COLS):
            r, c = divmod(idx, GOB_MB_COLS)
            mb_row = grow * GOB_MB_ROWS + r
            mb_col = gcol * GOB_MB_COLS + c
            perm.append(mb_row * fmt.mb_cols + mb_col)
    return np.asarray(perm, dtype=np.int32)


def gob_of_mb(fmt: Format) -> np.ndarray:
    """For each raster MB index, the GOB index (0-based, transmission order)."""
    out = np.empty(fmt.num_mbs, dtype=np.int32)
    perm = transmission_order(fmt)
    for k, raster in enumerate(perm):
        out[raster] = k // (GOB_MB_ROWS * GOB_MB_COLS)
    return out


def to_gob_order(fmt: Format, x: jnp.ndarray) -> jnp.ndarray:
    """Raster-MB-order (nMB, ...) -> (nGOB, 33, ...), gather-free.

    The transmission permutation is exactly a reshape/transpose: raster MB
    grid (grows*3, gcols*11) -> (grow, r, gcol, c) -> (grow, gcol, r, c).
    Equals x[transmission_order(fmt)].reshape(nGOB, 33, ...) (tested) but
    lowers to a pure layout transform instead of a gather.
    """
    gr, gc = fmt.gob_rows, fmt.gob_cols
    tail = x.shape[1:]
    x = x.reshape(gr, GOB_MB_ROWS, gc, GOB_MB_COLS, *tail)
    x = jnp.moveaxis(x, 2, 1)
    return x.reshape(fmt.num_gobs, GOB_MB_ROWS * GOB_MB_COLS, *tail)


def from_gob_order(fmt: Format, xt: jnp.ndarray) -> jnp.ndarray:
    """Inverse of to_gob_order: (nGOB, 33, ...) -> raster (nMB, ...)."""
    gr, gc = fmt.gob_rows, fmt.gob_cols
    tail = xt.shape[2:]
    x = xt.reshape(gr, gc, GOB_MB_ROWS, GOB_MB_COLS, *tail)
    x = jnp.moveaxis(x, 1, 2)
    return x.reshape(fmt.num_mbs, *tail)


# ---------------------------------------------------------------------------
# jnp reshape helpers (pure layout transforms; all shapes static)
# ---------------------------------------------------------------------------


def plane_to_tiles(plane: jnp.ndarray, tile: int) -> jnp.ndarray:
    """(H, W) -> (H//t * W//t, t, t) in raster tile order."""
    h, w = plane.shape[-2:]
    lead = plane.shape[:-2]
    x = plane.reshape(*lead, h // tile, tile, w // tile, tile)
    x = jnp.swapaxes(x, -3, -2)
    return x.reshape(*lead, (h // tile) * (w // tile), tile, tile)


def tiles_to_plane(tiles: jnp.ndarray, h: int, w: int, tile: int) -> jnp.ndarray:
    """Inverse of plane_to_tiles."""
    lead = tiles.shape[:-3]
    x = tiles.reshape(*lead, h // tile, w // tile, tile, tile)
    x = jnp.swapaxes(x, -3, -2)
    return x.reshape(*lead, h, w)


def luma_to_mbs(y: jnp.ndarray) -> jnp.ndarray:
    """(H, W) -> (nMB, 16, 16), raster MB order."""
    return plane_to_tiles(y, MB_SIZE)


def mbs_to_luma(mbs: jnp.ndarray, h: int, w: int) -> jnp.ndarray:
    return tiles_to_plane(mbs, h, w, MB_SIZE)


def mb_to_yblocks(mbs: jnp.ndarray) -> jnp.ndarray:
    """(nMB, 16, 16) -> (nMB, 4, 8, 8) in H.261 order Y1 Y2 Y3 Y4
    (top-left, top-right, bottom-left, bottom-right)."""
    lead = mbs.shape[:-2]
    x = mbs.reshape(*lead, 2, BLOCK_SIZE, 2, BLOCK_SIZE)
    x = jnp.swapaxes(x, -3, -2)  # (..., 2, 2, 8, 8)
    return x.reshape(*lead, 4, BLOCK_SIZE, BLOCK_SIZE)


def yblocks_to_mb(blocks: jnp.ndarray) -> jnp.ndarray:
    """Inverse of mb_to_yblocks: (nMB, 4, 8, 8) -> (nMB, 16, 16)."""
    lead = blocks.shape[:-3]
    x = blocks.reshape(*lead, 2, 2, BLOCK_SIZE, BLOCK_SIZE)
    x = jnp.swapaxes(x, -3, -2)
    return x.reshape(*lead, MB_SIZE, MB_SIZE)


def chroma_to_blocks(c: jnp.ndarray) -> jnp.ndarray:
    """(H/2, W/2) -> (nMB, 8, 8): one chroma block per MB, raster order."""
    return plane_to_tiles(c, BLOCK_SIZE)


def assemble_blocks(y_mbs: jnp.ndarray, cb_blocks: jnp.ndarray,
                    cr_blocks: jnp.ndarray) -> jnp.ndarray:
    """(nMB,16,16) luma MBs + (nMB,8,8) chroma blocks
    -> (nMB, 6, 8, 8) in transmission block order Y1..Y4, Cb, Cr."""
    yb = mb_to_yblocks(y_mbs)
    return jnp.concatenate([yb, cb_blocks[..., None, :, :],
                            cr_blocks[..., None, :, :]], axis=-3)


def assemble_mb_blocks(y_mbs: jnp.ndarray, cb: jnp.ndarray,
                       cr: jnp.ndarray) -> jnp.ndarray:
    """Like assemble_blocks but taking chroma PLANES (H/2, W/2)."""
    return assemble_blocks(y_mbs, chroma_to_blocks(cb), chroma_to_blocks(cr))
