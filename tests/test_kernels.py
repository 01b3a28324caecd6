"""Kernel-level tests: integer DCT vs float oracle, quant/dequant laws,
loop filter arithmetic, layout transforms, and ME vs a numpy brute force."""

import numpy as np
import pytest

import jax.numpy as jnp

from p64tpu.core import blocks
from p64tpu.kernels import dct, filter as lf, me, quant
from p64tpu.spec.constants import CIF, QCIF

RNG = np.random.default_rng(0)


def test_dct_matches_float_oracle_closely():
    x = RNG.integers(-255, 256, size=(512, 8, 8), dtype=np.int64)
    got = np.asarray(dct.fdct8x8(jnp.asarray(x, dtype=jnp.int32)))
    want = dct.reference_fdct(x)
    err = np.abs(got - want)
    assert err.max() <= 1.5, err.max()


def test_idct_matches_float_oracle_closely():
    c = RNG.integers(-2048, 2048, size=(512, 8, 8), dtype=np.int64)
    got = np.asarray(dct.idct8x8(jnp.asarray(c, dtype=jnp.int32)))
    want = dct.reference_idct(c)
    err = np.abs(got - want)
    assert err.max() <= 2.0, err.max()
    assert np.mean(err) < 0.5  # typical error well within one LSB


def test_dct_idct_roundtrip_small_error():
    x = RNG.integers(0, 256, size=(256, 8, 8), dtype=np.int64)
    f = dct.fdct8x8(jnp.asarray(x, dtype=jnp.int32))
    y = np.asarray(dct.idct8x8(f))
    assert np.abs(y - x).max() <= 2


def test_dct_zero_is_zero():
    z = jnp.zeros((4, 8, 8), jnp.int32)
    assert not np.asarray(dct.fdct8x8(z)).any()
    assert not np.asarray(dct.idct8x8(z)).any()


def test_dct_int32_bounds_safe():
    # worst-case magnitude inputs must not overflow int32 intermediates:
    # compare against an int64 recomputation.
    x = np.full((1, 8, 8), 255, dtype=np.int64)
    x[:, ::2] = -255
    mi = dct.MI.astype(np.int64)
    sb = dct.FWD_SCALE_BITS
    s64 = np.einsum("nx,ux->nu", x.reshape(-1, 64), dct.MI2.astype(np.int64))
    f64 = ((s64 + (1 << (sb - 1))) >> sb).reshape(-1, 8, 8)
    got = np.asarray(dct.fdct8x8(jnp.asarray(x, dtype=jnp.int32)))
    np.testing.assert_array_equal(got, f64)
    # analytic forward worst case stays inside int32 for any |f| <= 255
    assert int(np.abs(dct.MI2.astype(np.int64)).sum(axis=1).max()) * 255 \
        + (1 << (sb - 1)) < 2 ** 31
    c = np.where(RNG.integers(0, 2, (8, 8, 8)) > 0, 2047, -2048).astype(np.int64)
    s1, s2 = dct.INV_SHIFT1, dct.INV_SHIFT2
    t64 = (np.einsum("ux,nuv->nxv", mi, c) + (1 << (s1 - 1))) >> s1
    y64 = (np.einsum("nxv,vy->nxy", t64, mi) + (1 << (s2 - 1))) >> s2
    got = np.asarray(dct.idct8x8(jnp.asarray(c, dtype=jnp.int32)))
    np.testing.assert_array_equal(got, y64)
    # analytic worst-case stage-2 magnitude stays inside int32 for ANY
    # (foreign-stream) coefficient block.
    colmax = int(np.abs(mi).sum(axis=0).max())
    t_max = (colmax * 2048 + (1 << (s1 - 1))) >> s1
    assert t_max * colmax + (1 << (s2 - 1)) < 2 ** 31


def test_idct_ieee1180_conformance():
    """IEEE Std 1180-1990 statistical accuracy of the inverse DCT.

    H.261 requires decoder IDCTs to meet the IEEE-1180 bounds (H.261
    section 3.2.3); this is what makes decoding *foreign* compliant
    streams legal.  Procedure: random blocks in [-L, H], forward float64
    DCT -> rounded/clamped coefficients -> integer IDCT under test vs the
    rounded float64 oracle.  Bounds: ppe <= 1, pmse <= 0.06, omse <= 0.02,
    pme <= 0.015, ome <= 0.0015; plus zero-in -> zero-out.
    """
    nblocks = 10000
    for (L, H) in ((256, 255), (5, 5), (300, 300)):
        for sign in (1, -1):
            rng = np.random.default_rng(1180 + L + sign)
            f = rng.integers(-L, H + 1, (nblocks, 8, 8)).astype(np.int64)
            f *= sign
            F = np.round(dct.reference_fdct(f)).clip(-2048, 2047)
            ref = np.round(dct.reference_idct(F)).clip(-256, 255)
            got = np.asarray(
                dct.idct8x8(jnp.asarray(F, jnp.int32))).clip(-256, 255)
            e = (got - ref).astype(np.float64)
            tag = f"L={L} H={H} sign={sign}"
            assert np.abs(e).max() <= 1, tag                    # ppe
            assert (e ** 2).mean(axis=0).max() <= 0.06, tag     # pmse
            assert (e ** 2).mean() <= 0.02, tag                 # omse
            assert np.abs(e.mean(axis=0)).max() <= 0.015, tag   # pme
            assert abs(e.mean()) <= 0.0015, tag                 # ome
    zero = np.asarray(dct.idct8x8(jnp.zeros((4, 8, 8), jnp.int32)))
    assert not zero.any()


def test_quant_dequant_laws():
    q = 7  # odd
    c = jnp.asarray(np.arange(-300, 301).reshape(-1, 1) *
                    np.ones((1, 64), np.int64), jnp.int32)
    c88 = quant.zigzag_unscan(c)
    lv = quant.quantize(c88, jnp.int32(q), jnp.asarray(False))
    # dead zone: |coef| < 2q -> 0
    flat = np.asarray(quant.zigzag_unscan(lv)).reshape(-1, 64)
    cc = np.asarray(c88).reshape(-1, 64)
    assert (flat[np.abs(cc) < 2 * q] == 0).all()
    # reconstruction parity rules
    rec = np.asarray(quant.dequantize(lv, jnp.int32(q), jnp.asarray(False)))
    lvl = np.asarray(quant.zigzag_unscan(lv))
    pos = lvl > 0
    np.testing.assert_array_equal(rec[pos], q * (2 * lvl[pos] + 1))
    neg = lvl < 0
    np.testing.assert_array_equal(rec[neg], q * (2 * lvl[neg] - 1))
    # even quant: one closer to zero
    q2 = 8
    lv2 = quant.quantize(c88, jnp.int32(q2), jnp.asarray(False))
    rec2 = np.asarray(quant.dequantize(lv2, jnp.int32(q2), jnp.asarray(False)))
    lvl2 = np.asarray(quant.zigzag_unscan(lv2))
    pos = lvl2 > 0
    np.testing.assert_array_equal(rec2[pos], q2 * (2 * lvl2[pos] + 1) - 1)


def test_quant_intra_dc():
    c = np.zeros((5, 8, 8), np.int64)
    c[:, 0, 0] = [0, 5, 1020, 2040, 4]
    lv = np.asarray(quant.quantize(jnp.asarray(c, jnp.int32), jnp.int32(10),
                                   jnp.asarray(True)))
    # (dc+4)>>3 clamped to 1..254
    assert lv[:, 0].tolist() == [1, 1, 128, 254, 1]
    rec = np.asarray(quant.dequantize(jnp.asarray(lv), jnp.int32(10),
                                      jnp.asarray(True)))
    assert rec[:, 0, 0].tolist() == [8, 8, 1024, 2032, 8]


def test_level_clamp():
    c = np.zeros((1, 8, 8), np.int64)
    c[0, 3, 3] = 2047
    lv = np.asarray(quant.quantize(jnp.asarray(c, jnp.int32), jnp.int32(1),
                                   jnp.asarray(False)))
    assert np.abs(lv).max() == 127


def test_loop_filter():
    b = RNG.integers(0, 256, size=(32, 8, 8), dtype=np.int64)
    got = np.asarray(lf.loop_filter8x8(jnp.asarray(b, jnp.int32)))
    # numpy oracle, straight from the documented formula
    h = np.empty_like(b)
    h[..., 0] = 4 * b[..., 0]
    h[..., 7] = 4 * b[..., 7]
    h[..., 1:7] = b[..., :6] + 2 * b[..., 1:7] + b[..., 2:]
    v = np.empty_like(h)
    v[..., 0, :] = 4 * h[..., 0, :]
    v[..., 7, :] = 4 * h[..., 7, :]
    v[..., 1:7, :] = h[..., :6, :] + 2 * h[..., 1:7, :] + h[..., 2:, :]
    want = (v + 8) >> 4
    np.testing.assert_array_equal(got, want)
    # corners are identity
    np.testing.assert_array_equal(got[:, 0, 0], b[:, 0, 0])
    np.testing.assert_array_equal(got[:, 7, 7], b[:, 7, 7])
    # constant block is a fixed point
    cst = np.full((1, 8, 8), 77, np.int64)
    np.testing.assert_array_equal(
        np.asarray(lf.loop_filter8x8(jnp.asarray(cst, jnp.int32))), cst)


def test_layout_roundtrip():
    for fmt in (QCIF, CIF):
        y = RNG.integers(0, 256, size=(fmt.height, fmt.width), dtype=np.int64)
        mbs = blocks.luma_to_mbs(jnp.asarray(y))
        assert mbs.shape == (fmt.num_mbs, 16, 16)
        back = np.asarray(blocks.mbs_to_luma(mbs, fmt.height, fmt.width))
        np.testing.assert_array_equal(back, y)
        yb = blocks.mb_to_yblocks(mbs)
        np.testing.assert_array_equal(np.asarray(blocks.yblocks_to_mb(yb)),
                                      np.asarray(mbs))
        # block order: Y1 = top-left 8x8 of the MB
        np.testing.assert_array_equal(np.asarray(yb[0, 0]),
                                      y[:8, :8])
        np.testing.assert_array_equal(np.asarray(yb[0, 1]),
                                      y[:8, 8:16])
        np.testing.assert_array_equal(np.asarray(yb[0, 2]),
                                      y[8:16, :8])


def test_transmission_order_qcif():
    perm = blocks.transmission_order(QCIF)
    assert perm.shape == (99,)
    assert sorted(perm.tolist()) == list(range(99))
    # first GOB covers MB rows 0..2, full width; MBA 1 is MB (0,0)
    assert perm[0] == 0
    assert perm[10] == 10       # MBA 11 -> (0,10)
    assert perm[11] == 11       # MBA 12 -> (1,0) = raster 11
    assert perm[33] == 33       # GOB 2 starts at MB row 3


def test_transmission_order_cif():
    perm = blocks.transmission_order(CIF)
    assert sorted(perm.tolist()) == list(range(396))
    # GOB 2 (index 1) is the top-RIGHT GOB: its MBA 1 is raster MB (0, 11)
    assert perm[33] == 11
    # GOB 3 (index 2) starts at MB row 3, col 0
    assert perm[66] == 3 * 22


def test_full_search_matches_numpy_bruteforce():
    fmt = QCIF
    h, w = 48, 64  # small synthetic picture, multiple MBs
    ref = RNG.integers(0, 256, size=(h, w), dtype=np.int64)
    # current = ref shifted by (+3, -2) with noise, so MVs are findable
    cur = np.roll(np.roll(ref, 3, axis=0), -2, axis=1).copy()
    cur += RNG.integers(-2, 3, size=cur.shape)
    cur = np.clip(cur, 0, 255)

    mv, best, sad0 = me.full_search(jnp.asarray(cur), jnp.asarray(ref),
                                    search=4)
    mv, best, sad0 = map(np.asarray, (mv, best, sad0))

    offs = me.offset_table(4)
    n_mb = (h // 16) * (w // 16)
    for k in range(n_mb):
        y0, x0 = (k // (w // 16)) * 16, (k % (w // 16)) * 16
        cmb = cur[y0:y0 + 16, x0:x0 + 16]
        bs, bmv = None, None
        s0 = None
        for dy, dx in offs:
            yy, xx = y0 + dy, x0 + dx
            if yy < 0 or xx < 0 or yy + 16 > h or xx + 16 > w:
                continue
            s = int(np.abs(cmb - ref[yy:yy + 16, xx:xx + 16]).sum())
            if dy == 0 and dx == 0:
                s0 = s
            if bs is None or s < bs:  # strict <, scan order
                bs, bmv = s, (dx, dy)
        assert best[k] == bs
        assert tuple(mv[k]) == bmv
        assert sad0[k] == s0
    del fmt


@pytest.mark.parametrize("fmt", [QCIF])
def test_full_search_edge_clipping(fmt):
    # identical frames: best MV must be (0,0) everywhere (SAD 0, scan order
    # reaches (0,0) only via ties -- ensure edge MBs never pick out-of-range)
    y = RNG.integers(0, 256, size=(fmt.height, fmt.width), dtype=np.int64)
    mv, best, sad0 = me.full_search(jnp.asarray(y), jnp.asarray(y))
    assert (np.asarray(best) == 0).all()
    assert (np.asarray(sad0) == 0).all()


def test_mc_predict_select_matches_gather():
    from p64tpu.core import predict
    fmt = QCIF
    n = fmt.num_mbs
    ref_y = jnp.asarray(RNG.integers(0, 256, (fmt.height, fmt.width)),
                        jnp.int32)
    ref_cb = jnp.asarray(RNG.integers(0, 256,
                                      (fmt.chroma_height, fmt.chroma_width)),
                         jnp.int32)
    ref_cr = ref_cb + 1
    # valid MVs only: windows must stay inside the picture
    mbc = fmt.mb_cols
    idx = np.arange(n)
    y0, x0 = (idx // mbc) * 16, (idx % mbc) * 16
    mv = RNG.integers(-15, 16, (n, 2)).astype(np.int32)
    mv[:, 0] = np.clip(mv[:, 0], -x0, fmt.width - 16 - x0)
    mv[:, 1] = np.clip(mv[:, 1], -y0, fmt.height - 16 - y0)
    fil = RNG.random(n) < 0.5
    a = predict.mc_predict(ref_y, ref_cb, ref_cr, jnp.asarray(mv),
                           jnp.asarray(fil), fmt)
    b = predict.mc_predict_gather(ref_y, ref_cb, ref_cr, jnp.asarray(mv),
                                  jnp.asarray(fil), fmt)
    for x, y, name in zip(a, b, ("y", "cb", "cr")):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=name)


def test_sad_map_shifted_matches_dynamic():
    cur = jnp.asarray(RNG.integers(0, 256, (96, 112)), jnp.int32)
    ref = jnp.asarray(RNG.integers(0, 256, (96, 112)), jnp.int32)
    for s in (4, 7):
        np.testing.assert_array_equal(
            np.asarray(me.sad_map_shifted(cur, ref, s)),
            np.asarray(me.sad_map(cur, ref, s)))


def test_quantize_magic_division_domain():
    """The VPU-friendly magic-multiply division in kernels.quant must equal
    trunc-toward-zero division over its whole documented domain:
    |coef| <= 2047 (forward-DCT bound), 2*QUANT in 2..62."""
    from p64tpu.kernels.quant import _DIV_K, _DIV_MAGIC
    x = np.arange(0, 2048, dtype=np.int64)
    d = np.arange(1, 63, dtype=np.int64)
    got = (x[:, None] * _DIV_MAGIC[d][None, :].astype(np.int64)) >> _DIV_K
    np.testing.assert_array_equal(got, x[:, None] // d[None, :])


def test_quantize_matches_plain_division():
    from p64tpu.kernels.quant import quantize
    rng = np.random.default_rng(11)
    coefs = rng.integers(-2047, 2048, (64, 8, 8))
    for q in (1, 2, 7, 16, 31):
        lv = np.asarray(quantize(jnp.asarray(coefs), jnp.int32(q),
                                 jnp.asarray(False)))
        want = np.sign(coefs) * (np.abs(coefs) // (2 * q))
        want = np.clip(want, -127, 127)
        from p64tpu.kernels.quant import zigzag_scan
        want_zz = np.asarray(zigzag_scan(jnp.asarray(want)))
        np.testing.assert_array_equal(lv, want_zz)


def test_fdct_mxu_formulation_matches_int32():
    """The bf16-split tensor-core fdct must equal the int32 definition exactly
    over the input domain (residuals/pixels in [-255, 255]), including
    max-amplitude checkerboard corners."""
    from p64tpu.kernels import dct as d
    rng = np.random.default_rng(5)
    blocks = rng.integers(-255, 256, (2000, 8, 8)).astype(np.int32)
    corners = []
    for pat in range(8):
        b = np.full((8, 8), 255, np.int32)
        if pat & 1:
            b[::2] *= -1
        if pat & 2:
            b[:, ::2] *= -1
        if pat & 4:
            b = -b
        corners.append(b)
    blocks = np.concatenate([blocks, np.stack(corners)])
    # int64 oracle of the documented single-stage definition
    s = np.einsum("nx,ux->nu", blocks.reshape(-1, 64).astype(np.int64),
                  d.MI2.astype(np.int64))
    want = ((s + (1 << (d.FWD_SCALE_BITS - 1))) >> d.FWD_SCALE_BITS
            ).reshape(-1, 8, 8)
    got = np.asarray(d.fdct8x8(jnp.asarray(blocks)))
    np.testing.assert_array_equal(got, want)
    from p64tpu.spec.zigzag import ZIGZAG
    got_zz = np.asarray(d.fdct8x8_zz(jnp.asarray(blocks)))
    np.testing.assert_array_equal(got_zz,
                                  want.reshape(-1, 64)[:, np.asarray(ZIGZAG)])
