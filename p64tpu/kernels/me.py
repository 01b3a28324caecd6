"""Full-search integer-pel motion estimation, batched over all macroblocks.

Reference behavior (SURVEY sections 2/3c: me.c BruteMotionEstimation; mount
empty this round, unverified): exhaustive SAD over a +/-15 window per 16x16
luma MB, windows clipped so motion vectors never reference pixels outside
the picture ([SPEC] H.261 section 3.2.1), argmin with a deterministic scan
order defining tie-breaks.

Design (SURVEY section 7 "flagship kernel"): instead of the reference's
quadruple scalar loop, the dense SAD tensor (num_offsets, nMB) is computed
for all macroblocks at once; argmin over the offset axis picks the winner.
`sad_map` is the plain oracle, `sad_map_shifted` the XLA formulation and
`me_triton.sad_map_triton` the GPU kernel; `kernels.dispatch` picks one.

Documented choice contract (centralized here for recalibration once the
reference mount appears -- a different scan order only changes *tie* cases):

  * scan order: dy from -search..+search (outer), dx from -search..+search
    (inner); `jnp.argmin` keeps the FIRST minimum => strict-< updates in
    that order.
  * offsets whose 16x16 window leaves the picture are excluded (SAD = +inf).
  * no zero-MV bias here; the zero-vs-MC preference is applied by the mode
    decision layer (p64tpu.control.decisions).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..spec.constants import DEFAULT_SEARCH_RANGE, MB_SIZE


def offset_table(search: int = DEFAULT_SEARCH_RANGE) -> np.ndarray:
    """(num_offsets, 2) array of (dy, dx) in the documented scan order."""
    r = np.arange(-search, search + 1)
    dy, dx = np.meshgrid(r, r, indexing="ij")
    return np.stack([dy.ravel(), dx.ravel()], axis=-1).astype(np.int32)


def zero_offset_index(search: int = DEFAULT_SEARCH_RANGE) -> int:
    side = 2 * search + 1
    return search * side + search


def validity_mask(h: int, w: int, search: int) -> jnp.ndarray:
    """(num_offsets, nMB) bool: the offset keeps the MB inside the picture."""
    mb_cols = w // MB_SIZE
    n_mb = (h // MB_SIZE) * mb_cols
    y0 = (jnp.arange(n_mb, dtype=jnp.int32) // mb_cols) * MB_SIZE
    x0 = (jnp.arange(n_mb, dtype=jnp.int32) % mb_cols) * MB_SIZE
    offs = jnp.asarray(offset_table(search))
    oy, ox = offs[:, 0:1], offs[:, 1:2]
    return ((y0[None, :] + oy >= 0) & (y0[None, :] + oy + MB_SIZE <= h)
            & (x0[None, :] + ox >= 0) & (x0[None, :] + ox + MB_SIZE <= w))


def sad_map_shifted(cur_y: jnp.ndarray, ref_y: jnp.ndarray,
                    search: int = DEFAULT_SEARCH_RANGE) -> jnp.ndarray:
    """SAD map in plain XLA (the CPU's formulation): the 2*search+1 horizontal shifts of the padded
    reference are materialized once as static slices, then a static loop
    over dy takes |cur - shifted| for all dx at once and box-sums it per
    macroblock with two 0/1 pooling matmuls.  Bit-identical to sad_map.
    """
    h, w = cur_y.shape
    mb_rows, mb_cols = h // MB_SIZE, w // MB_SIZE
    n_mb = mb_rows * mb_cols
    side = 2 * search + 1
    # pixels and |differences| are integers <= 255 and the box sums stay
    # below 2^24, so f32 is exact throughout
    dt = jnp.float32
    cur = cur_y.astype(dt)[None]                           # (1, h, w)
    ref_pad = jnp.pad(ref_y.astype(dt), search)
    # (side, h + 2s, w): lane-misaligned slicing paid once, here.
    shifted = jnp.stack([ref_pad[:, dx:dx + w] for dx in range(side)])

    # 0/1 pooling matrices turn the 16x16 box sums into matmuls
    pr = jnp.asarray(np.kron(np.eye(mb_rows, dtype=np.float32),
                             np.ones((1, MB_SIZE), np.float32)))  # (R, h)
    pc = jnp.asarray(np.kron(np.eye(mb_cols, dtype=np.float32),
                             np.ones((MB_SIZE, 1), np.float32)))  # (w, C)

    def one_dy(dy):
        ad = jnp.abs(cur - jax.lax.slice_in_dim(
            shifted, dy, dy + h, axis=1))                  # (side, h, w)
        # 0/1 times integers <= 255: exact at any precision, TF32
        # included; stated so that no default decides it
        part = jax.lax.dot_general(
            pc.astype(dt), ad,
            dimension_numbers=(((0,), (2,)), ((), ())),
            precision=jax.lax.Precision.DEFAULT,
            preferred_element_type=jnp.float32)            # (C, side, h)
        # HIGHEST: `part` holds integers up to 16*255 = 4080, beyond the
        # exact integer range of bf16 and TF32 (11 significant bits)
        sums = jax.lax.dot_general(
            part, pr, dimension_numbers=(((2,), (1,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32)            # (C, side, R)
        return jnp.transpose(sums, (1, 2, 0)).reshape(side, n_mb)

    # static unroll over dy keeps every slice aligned & compile-time known
    sads = jnp.stack([one_dy(dy) for dy in range(side)])   # (dy, dx, nMB)
    sads = sads.reshape(side * side, n_mb).astype(jnp.int32)

    valid = validity_mask(h, w, search)
    big = jnp.int32(1 << 30)
    return jnp.where(valid, sads, big)


def sad_map(cur_y: jnp.ndarray, ref_y: jnp.ndarray,
            search: int = DEFAULT_SEARCH_RANGE) -> jnp.ndarray:
    """Dense SAD tensor.

    Args:
      cur_y, ref_y: (H, W) luma planes (any integer dtype).

    Returns:
      (num_offsets, nMB) int32; invalid (out-of-picture) offsets are BIG.
    """
    h, w = cur_y.shape
    mb_rows, mb_cols = h // MB_SIZE, w // MB_SIZE
    n_mb = mb_rows * mb_cols
    side = 2 * search + 1
    cur = cur_y.astype(jnp.int32)
    ref_pad = jnp.pad(ref_y.astype(jnp.int32), search)

    dxs = jnp.arange(-search, search + 1)

    def row_sads(dy):
        def one_dx(dx):
            shifted = jax.lax.dynamic_slice(
                ref_pad, (search + dy, search + dx), (h, w))
            ad = jnp.abs(cur - shifted)
            return ad.reshape(mb_rows, MB_SIZE, mb_cols, MB_SIZE).sum(
                axis=(1, 3)).reshape(n_mb)
        return jax.vmap(one_dx)(dxs)  # (side, nMB)

    sads = jax.lax.map(row_sads, jnp.arange(-search, search + 1))
    sads = sads.reshape(side * side, n_mb)

    valid = validity_mask(h, w, search)
    big = jnp.int32(1 << 30)
    return jnp.where(valid, sads, big)


def sad_map_np(cur: np.ndarray, ref: np.ndarray, search: int) -> np.ndarray:
    """int64 numpy oracle of sad_map, independent of JAX: the same
    (num_offsets, nMB) layout and scan order, invalid offsets BIG."""
    h, w = cur.shape
    mbr, mbc = h // MB_SIZE, w // MB_SIZE
    n_mb = mbr * mbc
    c = cur.astype(np.int64)
    rp = np.pad(ref.astype(np.int64), search)
    out = np.full((len(offset_table(search)), n_mb), 1 << 30, np.int64)
    y0 = (np.arange(n_mb) // mbc) * MB_SIZE
    x0 = (np.arange(n_mb) % mbc) * MB_SIZE
    for k, (dy, dx) in enumerate(offset_table(search)):
        win = rp[search + dy:search + dy + h, search + dx:search + dx + w]
        s = np.abs(c - win).reshape(mbr, MB_SIZE, mbc, MB_SIZE).sum((1, 3))
        ok = ((y0 + dy >= 0) & (x0 + dx >= 0)
              & (y0 + dy + MB_SIZE <= h) & (x0 + dx + MB_SIZE <= w))
        out[k, ok] = s.reshape(n_mb)[ok]
    return out


def full_search(cur_y: jnp.ndarray, ref_y: jnp.ndarray,
                search: int = DEFAULT_SEARCH_RANGE):
    """Returns (mv, best_sad, sad0):

      mv:       (nMB, 2) int32 (mvx, mvy) -- horizontal, vertical
      best_sad: (nMB,) int32 SAD at mv
      sad0:     (nMB,) int32 SAD at (0, 0)

    The SAD map comes from the formulation `kernels.dispatch` picks for
    the default backend.
    """
    from .dispatch import current_sad_formulation
    if current_sad_formulation() == "triton":
        from .me_triton import sad_map_triton
        sads = sad_map_triton(cur_y, ref_y, search)
    else:
        sads = sad_map_shifted(cur_y, ref_y, search)
    offs = jnp.asarray(offset_table(search))
    best_idx = jnp.argmin(sads, axis=0)
    best_sad = jnp.take_along_axis(sads, best_idx[None, :], axis=0)[0]
    sad0 = sads[zero_offset_index(search)]
    dydx = offs[best_idx]
    mv = jnp.stack([dydx[:, 1], dydx[:, 0]], axis=-1)  # (mvx, mvy)
    return mv, best_sad, sad0
