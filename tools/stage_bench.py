"""Per-stage device timing for the encoder hot path.

Each stage runs ITERS times inside one jitted `lax.fori_loop` with a
carried data dependency (so XLA cannot elide iterations), vmapped over 16
streams; the loop amortizes the launch overhead to noise and the division
gives per-iteration device time.

Usage: python tools/stage_bench.py [stage ...]   (default: all)
Output (stderr): per-stage ms per frame-step-equivalent at bench shapes.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


ITERS = int(os.environ.get("P64_STAGE_ITERS", "30"))
STREAMS = int(os.environ.get("P64_STAGE_STREAMS", "16"))


def main(argv):
    import jax
    import jax.numpy as jnp

    from p64tpu.utils import enable_compile_cache
    enable_compile_cache()

    from p64tpu.control.decisions import DecisionConfig, decide_modes
    from p64tpu.control.ratecontrol import RateConfig
    from p64tpu.core import encoder as enc
    from p64tpu.core.blocks import (assemble_blocks, assemble_mb_blocks,
                                    luma_to_mbs, to_gob_order)
    from p64tpu.core.predict import mc_predict
    from p64tpu.core.reconstruct import reconstruct_frame
    from p64tpu.entropy import lengths
    from p64tpu.kernels.dct import fdct8x8_zz
    from p64tpu.kernels.me import full_search
    from p64tpu.kernels.quant import quantize_zz
    from p64tpu.spec.constants import CIF

    fmt = CIF
    n_mb = fmt.num_mbs
    rng = np.random.default_rng(0)
    h, w = fmt.height, fmt.width

    cur_y = jnp.asarray(rng.integers(0, 256, (STREAMS, h, w), np.int32))
    ref_y = jnp.asarray(rng.integers(0, 256, (STREAMS, h, w), np.uint8))
    ref_cb = jnp.asarray(rng.integers(0, 256,
                                      (STREAMS, h // 2, w // 2), np.uint8))
    ref_cr = ref_cb
    mv = jnp.asarray(rng.integers(-15, 16, (STREAMS, n_mb, 2), np.int32))
    fil = jnp.asarray(rng.integers(0, 2, (STREAMS, n_mb)).astype(bool))
    intra = jnp.asarray(rng.integers(0, 4, (STREAMS, n_mb)) == 0)
    levels = jnp.asarray(
        rng.integers(-8, 9, (STREAMS, n_mb, 6, 64), np.int32)
        * (rng.random((STREAMS, n_mb, 6, 64)) < 0.1))
    quant_mb = jnp.full((STREAMS, n_mb), 10, jnp.int32)
    blocks = jnp.asarray(rng.integers(-255, 256,
                                      (STREAMS, n_mb, 6, 8, 8), np.int32))
    coefs = jnp.asarray(rng.integers(-2047, 2048,
                                     (STREAMS, n_mb, 6, 8, 8), np.int32))
    mtype = jnp.asarray(rng.integers(0, 4, (STREAMS, n_mb), np.int32))
    cbp = jnp.asarray(rng.integers(1, 64, (STREAMS, n_mb), np.int32))
    coded = jnp.asarray(rng.integers(0, 2, (STREAMS, n_mb)).astype(bool))

    cfg = enc.EncoderConfig(fmt=fmt, search=15,
                            rate=RateConfig(fixed_quant=10))

    def loop(fn, x0):
        """Run fn ITERS times with a carried int32 perturbation."""
        def body(i, carry):
            x, acc = carry
            out = fn(x + (i & 1), acc)
            return (x, acc + out)
        return jax.lax.fori_loop(0, ITERS, body,
                                 (x0, jnp.int32(0)))[1]

    stages = {}

    # --- motion estimation (production dispatch) ---
    def st_me(pert, acc):
        def one(cy, ry):
            mv_, bs, s0 = full_search(cy, ry, 15)
            return mv_.sum() + bs.sum() + s0.sum()
        return jax.vmap(one)(cur_y + pert, ref_y).sum()
    stages["me_full_search"] = (st_me, cur_y)

    # --- MC prediction (select sweep) ---
    def st_pred(pert, acc):
        def one(ry, rcb, rcr, mv_, f_):
            py, pcb, pcr = mc_predict(ry, rcb, rcr, mv_ * 0 + mv_ , f_, fmt)
            return py.sum() + pcb.sum() + pcr.sum()
        return jax.vmap(one)(ref_y, ref_cb, ref_cr,
                             mv + pert * 0, fil).sum()
    stages["mc_predict"] = (st_pred, mv)

    # --- decisions (incl. nothing heavy, but has its own mc_predict-free
    #     cost model) ---
    def st_dec(pert, acc):
        def one(cy, ry):
            cur_mbs = luma_to_mbs(cy)
            pred0 = luma_to_mbs(ry.astype(jnp.int32))
            d = decide_modes(cur_mbs, pred0, pred0,
                             jnp.full(n_mb, 1000, jnp.int32) + cy[0, 0],
                             jnp.full(n_mb, 900, jnp.int32),
                             jnp.zeros((n_mb, 2), jnp.int32),
                             jnp.zeros(n_mb, jnp.int32), False,
                             DecisionConfig())
            return d["mv_out"].sum() + d["intra"].sum()
        return jax.vmap(one)(cur_y, ref_y).sum()
    stages["decide_modes"] = (st_dec, cur_y)

    # --- forward DCT ---
    def st_dct(pert, acc):
        return fdct8x8_zz(blocks + pert).sum()
    stages["fdct"] = (st_dct, blocks)

    # --- quantize + cbp/mtype derivation + exact length model (the
    #     fixed-q single-shot process_gob over all 12 GOBs) ---
    def st_quant_len(pert, acc):
        def one(cf, it, mvv):
            c_t = to_gob_order(fmt, cf).reshape(-1, 33, 6, 64)
            i_t = to_gob_order(fmt, it)
            m_t = to_gob_order(fmt, mvv)
            lv = quantize_zz(c_t, jnp.int32(10), i_t[..., None, None])
            nz = (lv != 0).any(axis=-1)
            wts = jnp.asarray([32, 16, 8, 4, 2, 1], jnp.int32)
            cbp_ = jnp.where(nz, wts, 0).sum(axis=-1)
            mt = jnp.where(i_t, 0, 3)
            cd = cbp_ > 0
            bits = lengths.gob_payload_bits(cd, mt, m_t, cbp_, lv)
            return bits.sum()
        return jax.vmap(one)(coefs + pert, intra, mv).sum()
    stages["quant_plus_lengths"] = (st_quant_len, coefs)

    # --- quantize alone (zigzag pipeline) ---
    def st_quant(pert, acc):
        zz = (coefs + pert).reshape(STREAMS, n_mb, 6, 64)
        lv = quantize_zz(zz, jnp.int32(10), intra[..., None, None])
        return lv.sum()
    stages["quantize_only"] = (st_quant, coefs)

    # --- block_bits alone (per-coefficient run/length model) ---
    def st_blockbits(pert, acc):
        return lengths.block_bits(levels + pert * 0 + (pert & 1),
                                  intra[..., None]).sum()
    stages["block_bits_only"] = (st_blockbits, levels)

    # --- reconstruction (dequant+IDCT+predict+clip) ---
    def st_recon(pert, acc):
        def one(lv, q, im, mv_, f_, ry, rcb, rcr):
            y, cb, cr = reconstruct_frame(fmt, lv, q, im, mv_, f_,
                                          ry, rcb, rcr)
            return (y.astype(jnp.int32).sum() + cb.astype(jnp.int32).sum()
                    + cr.astype(jnp.int32).sum())
        return jax.vmap(one)(levels + pert * 0, quant_mb, intra, mv, fil,
                             ref_y, ref_cb, ref_cr).sum()
    stages["reconstruct"] = (st_recon, levels)

    # --- whole frame step (for cross-check: sum of stages ~ this).
    # NOTE: the returned value must depend on new_state too, or XLA
    # dead-code-eliminates the whole reconstruction (a fori body that
    # discards the carry measured 9.3 ms while the real scan step in
    # bench.py paid ~13.5 -- round-3 lesson). ---
    def st_frame(pert, acc):
        states = jax.tree.map(
            lambda x: jnp.broadcast_to(x, (STREAMS,) + x.shape),
            enc.init_state(cfg))
        states = dict(states, frame_idx=states["frame_idx"] + 1,
                      ref_y=ref_y)
        fr = dict(y=(cur_y + pert).astype(jnp.uint8), cb=ref_cb, cr=ref_cr)
        st2, out = jax.vmap(
            lambda s, f: enc.encode_frame_step(cfg, s, f))(states, fr)
        return (out["total_bits"].sum()
                + st2["ref_y"].astype(jnp.int32).sum()
                + st2["refresh"].sum())
    stages["frame_step"] = (st_frame, cur_y)

    want = argv[1:] or list(stages)
    log(f"backend={jax.default_backend()} streams={STREAMS} iters={ITERS}")
    results = {}
    for name in want:
        fn, x0 = stages[name]
        run = jax.jit(lambda x0=x0, fn=fn: loop(fn, x0))
        t0 = time.time()
        r = int(run())
        log(f"{name}: compile+run {time.time() - t0:.1f}s")
        best = float("inf")
        for _ in range(2):
            t0 = time.time()
            r = int(run())
            best = min(best, time.time() - t0)
        per = best / ITERS * 1e3
        results[name] = per
        log(f"{name}: {per:.3f} ms/iter  (checksum {r & 0xffff})")

    log("---- summary (ms per frame-step equivalent, 16 streams) ----")
    for k, v in results.items():
        log(f"{k:22s} {v:8.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
