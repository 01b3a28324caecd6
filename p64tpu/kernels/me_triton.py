"""Full-search SAD map as a Pallas kernel for the GPU (Triton route).

Same contract as `me.sad_map`: (num_offsets, nMB) int32 in the documented
dy-major scan order, out-of-picture offsets set to BIG.

One program per (MB row, 128-column tile, dy).  It loads the 16 current
rows of its tile once, then loops over the 2*search+1 horizontal offsets:
each step loads the matching 16x128 window of the padded reference (served
from L1/L2, never staged through device memory as a shifted copy), takes
|a - b| in int32 and sums it per 16x16 macroblock in registers.  The
per-dx sums of 8 macroblocks are collected into one (32, 8) tile and
stored once.  Planes are zero-padded in XLA so every load is in bounds
and every block shape is a power of two, as Triton requires; the padded
macroblock columns and invalid offsets are dropped or masked afterwards.

Exact by construction: integer arithmetic only, sums <= 16*16*255.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..spec.constants import DEFAULT_SEARCH_RANGE, MB_SIZE
from .me import validity_mask

TILE_W = 128                      # 8 macroblocks per program
_MBS_PER_TILE = TILE_W // MB_SIZE


def _kernel(cur_ref, ref_ref, out_ref, *, side: int, side_p: int):
    y0 = pl.program_id(0) * MB_SIZE
    x0 = pl.program_id(1) * TILE_W
    dy = pl.program_id(2)
    a = cur_ref[pl.ds(y0, MB_SIZE), pl.ds(x0, TILE_W)]
    slot = jax.lax.broadcasted_iota(jnp.int32, (side_p, _MBS_PER_TILE), 0)

    def one_dx(dx, acc):
        b = ref_ref[pl.ds(y0 + dy, MB_SIZE), pl.ds(x0 + dx, TILE_W)]
        d = jnp.abs(a - b).reshape(MB_SIZE, _MBS_PER_TILE, MB_SIZE)
        s = d.sum(axis=2).sum(axis=0)                     # (8,)
        return jnp.where(slot == dx, s[None, :], acc)

    out_ref[...] = jax.lax.fori_loop(
        0, side, one_dx, jnp.zeros((side_p, _MBS_PER_TILE), jnp.int32))


def sad_map_triton(cur_y: jnp.ndarray, ref_y: jnp.ndarray,
                   search: int = DEFAULT_SEARCH_RANGE,
                   interpret: bool = False) -> jnp.ndarray:
    """Dense SAD tensor, bit-identical to `me.sad_map`."""
    h, w = cur_y.shape
    mb_rows, mb_cols = h // MB_SIZE, w // MB_SIZE
    side = 2 * search + 1
    side_p = pl.next_power_of_2(side)
    n_tiles = pl.cdiv(w, TILE_W)
    wp = n_tiles * TILE_W
    cur = jnp.pad(cur_y.astype(jnp.int32), ((0, 0), (0, wp - w)))
    ref = jnp.pad(ref_y.astype(jnp.int32),
                  ((search, search), (search, search + wp - w)))

    kernel = functools.partial(_kernel, side=side, side_p=side_p)
    out = pl.pallas_call(
        kernel,
        grid=(mb_rows, n_tiles, side),
        in_specs=[pl.BlockSpec(cur.shape, lambda r, c, d: (0, 0)),
                  pl.BlockSpec(ref.shape, lambda r, c, d: (0, 0))],
        out_specs=pl.BlockSpec((None, None, None, side_p, _MBS_PER_TILE),
                               lambda r, c, d: (d, r, c, 0, 0)),
        out_shape=jax.ShapeDtypeStruct(
            (side, mb_rows, n_tiles, side_p, _MBS_PER_TILE), jnp.int32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="sad_map_triton",
    )(cur, ref)
    # (dy, R, T, dx, 8) -> (dy, dx, R, T*8) -> (side*side, nMB)
    sads = out[:, :, :, :side].transpose(0, 3, 1, 2, 4).reshape(
        side, side, mb_rows, wp // MB_SIZE)[..., :mb_cols]
    sads = sads.reshape(side * side, mb_rows * mb_cols)
    return jnp.where(validity_mask(h, w, search), sads, jnp.int32(1 << 30))
