"""Batched 8x8 integer DCT / IDCT.

The reference's production transform is an integer Chen DCT whose exact
fixed-point rounding defines the bitstream (SURVEY section 2: chendct.c
ChenDct/ChenIDct; the mount was empty this round, so the reference's exact
constants/shifts could NOT be transplanted -- see SURVEY section 0).  This
module therefore defines its *own* fully-specified integer transform with the
same role: deterministic int32 arithmetic, identical on every backend, shared
by encoder and decoder so encoder-local reconstruction and decoder output are
bit-identical by construction.  When the reference mount appears, only the
constants/shifts in this file need recalibrating for cross-implementation
bit-exactness.

Definition (documented contract):

  basis   M[u, x] = c(u)/2 * cos((2x+1) u pi / 16),  c(0)=1/sqrt(2), else 1
  rshift_round(v, s) = (v + 2^(s-1)) >> s            (arithmetic shift)

  forward (single-stage, round 3):
            MI2 = round(kron(M, M) * 2^15)           (16-bit signed constants)
            vec(F) = rshift_round(MI2 @ vec(f), 15)  # ONE rounding, scale 1

  inverse (two-stage separable):
            MI = round(M * 2^13)                     (14-bit signed constants)
            t = rshift_round(MI^T @ F, 9)            # keeps 4 fraction bits
            f = rshift_round(t @ MI,   17)

The forward is single-stage: the flattened (..., 64) @ (64, 64) form is
one matmul with no minor-dim-8 relayouts, and its single rounding is
strictly more accurate vs the float oracle than a separable two-stage
form.  The inverse stays separable (two 8x8 stages).

The inverse keeps 4 fraction bits in the intermediate so that the IDCT meets
the IEEE Std 1180-1990 statistical accuracy bounds required of H.261
decoders (H.261 section 3.2.3 / section 4.2.4.4): ppe <= 1, pmse <= 0.06,
omse <= 0.02, pme <= 0.015, ome <= 0.0015 -- enforced by
tests/test_kernels.py::test_idct_ieee1180_conformance.

Worst-case int32 bounds, valid for ARBITRARY (foreign-stream) inputs:
forward: max_row sum |MI2| = 221,262 < 2^17.8, so |sums| <= 255 * 2^17.8
< 2^25.8.  inverse: max_x sum_u |MI[u,x]| = 21641, so t <= 2^16.4 and
stage-2 products <= 2^30.8 -- no int32 overflow even for adversarial
coefficient blocks.  Output range: |F| <= 2047 after the caller's clamp;
inverse output is clamped by the caller during reconstruction.

A float64 separable DCT is provided as the test oracle (the reference's
"ReferenceDct" analogue, dct.c, unverified).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

SCALE_BITS = 13
FWD_SCALE_BITS = 15
INV_SHIFT1, INV_SHIFT2 = 9, 17


def _float_basis() -> np.ndarray:
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    m = 0.5 * np.cos((2 * x + 1) * u * np.pi / 16)
    m[0, :] *= 1.0 / np.sqrt(2.0)
    return m


#: float64 basis (oracle) and its fixed-point images (production constants):
#: MI (8x8) for the separable inverse, MI2 (64x64) for the single-stage
#: forward -- MI2[8u+v, 8x+y] = round(M[u,x] * M[v,y] * 2^15).
M_FLOAT: np.ndarray = _float_basis()
MI: np.ndarray = np.round(M_FLOAT * (1 << SCALE_BITS)).astype(np.int32)
MI2: np.ndarray = np.round(np.kron(M_FLOAT, M_FLOAT)
                           * (1 << FWD_SCALE_BITS)).astype(np.int32)
assert int(np.abs(MI2).sum(axis=1).max()) * 255 < 2 ** 31  # int32-safe


def rshift_round(v: jnp.ndarray, s: int) -> jnp.ndarray:
    """(v + 2^(s-1)) >> s with arithmetic shift: round-half-up in value."""
    return (v + (1 << (s - 1))) >> s


#: zigzag-ordered forward basis: row k of MI2_ZZ produces the k-th
#: zigzag-scan coefficient, so the encoder gets transmission-ordered
#: levels straight out of the DCT dot with ZERO permutation cost (the
#: zigzag gather in quantize measured as real VPU time in round 3).
#: Same numbers, different row order: fdct8x8_zz(x) == zigzag(fdct8x8(x)).
from ..spec.zigzag import ZIGZAG as _ZZ  # noqa: E402  (after MI2)

MI2_ZZ: np.ndarray = MI2[np.asarray(_ZZ)]

#: bf16 hi/lo split of MI2 for the tensor-core path: MI2 = 256*hi + lo with
#: hi in [-128, 128] and lo in [-128, 127] -- both bf16-exact integers.
_MI2_HI: np.ndarray = (MI2 + 128) >> 8
_MI2_LO: np.ndarray = MI2 - 256 * _MI2_HI
assert (np.abs(_MI2_HI) <= 128).all() and (np.abs(_MI2_LO) <= 128).all()
_MI2Z_HI: np.ndarray = (MI2_ZZ + 128) >> 8
_MI2Z_LO: np.ndarray = MI2_ZZ - 256 * _MI2Z_HI


def _fdct_flat(v: jnp.ndarray, hi: np.ndarray, lo: np.ndarray) -> jnp.ndarray:
    """(n, 64) -> (n, 64) rounded forward DCT as ONE bf16 tensor-core dot.

    Inputs f in [-255, 255] are bf16-exact; the basis is split
    256*hi + lo (both bf16-exact) and the two halves are concatenated into
    a single (64, 128) rhs.  Each f32 accumulator holds
    |sums| <= 64*255*128 < 2^21 (exact at any matmul precision); the
    256*hi + lo recombination happens in int32 (full sums reach 2^25.8,
    beyond f32's exact-integer range).  Bit-identical to the int32
    definition (tests/test_kernels.py, and p64tpu.tools.parity on the
    card), and faster than an int32 einsum on the GPU (PERF.md).
    """
    cat = jnp.concatenate([jnp.asarray(hi.T, jnp.bfloat16),
                           jnp.asarray(lo.T, jnp.bfloat16)], axis=1)
    s = jax.lax.dot(v.astype(jnp.bfloat16), cat,
                    preferred_element_type=jnp.float32)
    s2 = 256 * s[:, :64].astype(jnp.int32) + s[:, 64:].astype(jnp.int32)
    return rshift_round(s2, FWD_SCALE_BITS)


def fdct8x8(blocks: jnp.ndarray) -> jnp.ndarray:
    """Forward integer DCT over (..., 8, 8) int32 -> (..., 8, 8) int32."""
    v = blocks.reshape(-1, 64)
    return _fdct_flat(v, _MI2_HI, _MI2_LO).reshape(blocks.shape)


def fdct8x8_zz(blocks: jnp.ndarray) -> jnp.ndarray:
    """Forward integer DCT emitting ZIGZAG-ordered coefficients directly:
    (..., 8, 8) int32 -> (..., 64) int32 with
    fdct8x8_zz(x)[..., k] == zigzag(fdct8x8(x))[..., k].

    Same arithmetic as fdct8x8 (MI2 rows permuted -- see MI2_ZZ), so the
    transmission-order permutation costs nothing.  This is the encoder's
    production entry; fdct8x8 remains for (8, 8)-layout callers and tests."""
    v = blocks.reshape(-1, 64)
    out = _fdct_flat(v, _MI2Z_HI, _MI2Z_LO)
    return out.reshape(*blocks.shape[:-2], 64)


def idct8x8(coefs: jnp.ndarray) -> jnp.ndarray:
    """Inverse integer DCT over (..., 8, 8) int32 -> (..., 8, 8) int32."""
    mi = jnp.asarray(MI, dtype=jnp.int32)
    t = rshift_round(jnp.einsum("ux,...uv->...xv", mi, coefs.astype(jnp.int32)),
                     INV_SHIFT1)
    return rshift_round(jnp.einsum("...xv,vy->...xy", t, mi), INV_SHIFT2)


# ---------------------------------------------------------------------------
# float64 oracle (test-only; the dct.c "ReferenceDct" analogue)
# ---------------------------------------------------------------------------


def reference_fdct(blocks: np.ndarray) -> np.ndarray:
    m = M_FLOAT
    return np.einsum("ux,...xy,vy->...uv", m, blocks.astype(np.float64), m)


def reference_idct(coefs: np.ndarray) -> np.ndarray:
    m = M_FLOAT
    return np.einsum("ux,...uv,vy->...xy", m, coefs.astype(np.float64), m)
