"""Encoder config-space fuzz: random configurations x random content,
with the full self-consistency contract asserted on every sample:

  * encode_to_bytes succeeds (its internal serializer == device-bit-model
    assert runs on every encode);
  * our decoder round-trips the stream and the planes equal the
    encoder's local reconstruction EXACTLY (shared-reconstruction
    invariant) for every coded frame;
  * a resync parse of the CLEAN stream equals the strict parse (no
    damage flags, identical symbols);
  * total_bits equals the serialized bit count.

The per-config jit compile dominates runtime on CPU, so a budget of N
seconds covers roughly N/20 distinct configs; the sweep samples search
range, rate control on/off, MQUANT segments, intra period, loop filter,
emit_recon, frame counts, and content families (noise, flat, gradient,
bright -- the decision-overflow regime, dark, moving box).

    python tools/fuzz_encoder.py [seconds]      # default 300
"""

from __future__ import annotations

import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402


def make_content(rng, fmt, t, family):
    h, w = fmt.height, fmt.width
    if family == "noise":
        y = rng.integers(0, 256, (t, h, w))
    elif family == "flat":
        y = np.full((t, h, w), int(rng.integers(0, 256)))
    elif family == "gradient":
        yy, xx = np.mgrid[0:h, 0:w]
        y = np.broadcast_to((xx + yy) % 256, (t, h, w)).copy()
    elif family == "bright":
        y = rng.integers(182, 256, (t, h, w))     # mean > 181: the round-4
        #                                           variance-overflow regime
    elif family == "dark":
        y = rng.integers(0, 24, (t, h, w))
    else:  # moving box over texture
        base = rng.integers(0, 200, (h, w))
        y = np.stack([np.roll(base, 5 * k, axis=1) for k in range(t)])
        for k in range(t):
            y[k, 20:80, (10 + 11 * k) % (w - 64):][:, :64] = 255
    y = y.astype(np.uint8)
    c = rng.integers(0, 256, (t, h // 2, w // 2)).astype(np.uint8)
    return dict(y=y, cb=c, cr=(255 - c).astype(np.uint8))


def main() -> int:
    budget = float(sys.argv[1]) if len(sys.argv) > 1 else 300.0
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from p64tpu.utils import enable_compile_cache
    enable_compile_cache()

    from p64tpu.control.decisions import DecisionConfig
    from p64tpu.control.ratecontrol import RateConfig
    from p64tpu.core import encoder as enc
    from p64tpu.core.decoder import decode_stream
    from p64tpu.entropy import parse
    from p64tpu.spec.constants import CIF, QCIF

    rng = np.random.default_rng(int(os.environ.get("FUZZ_SEED", "77")))
    t0 = time.time()
    n = 0
    families = ["noise", "flat", "gradient", "bright", "dark", "moving"]
    while time.time() - t0 < budget:
        fmt = CIF if rng.random() < 0.2 else QCIF
        t = int(rng.integers(1, 6))
        search = int(rng.choice([0, 1, 2, 3, 7, 15]))
        if rng.random() < 0.5:
            rate = RateConfig(
                bit_rate=int(rng.integers(32, 4000)) * 1000,
                frame_rate=int(rng.choice([10, 25, 30])),
                mquant_segments=int(rng.choice([1, 1, 2, 3, 5])),
                initial_quant=int(rng.integers(2, 26)),
                min_rate_fill=bool(rng.random() < 0.8))
            if rate.mquant_segments > 1 and rate.bit_rate <= 0:
                rate = RateConfig(fixed_quant=8)
        else:
            rate = RateConfig(fixed_quant=int(rng.integers(1, 32)))
        cfg = enc.EncoderConfig(
            fmt=fmt, search=search, rate=rate,
            intra_only=search == 0,
            intra_period=int(rng.choice([0, 0, 1, 2, 3])),
            emit_recon=bool(rng.random() < 0.7),
            decisions=DecisionConfig(
                filter_with_mc=bool(rng.random() < 0.8)))
        family = families[int(rng.integers(len(families)))]
        frames = {k: jnp.asarray(v) for k, v in
                  make_content(rng, fmt, t, family).items()}

        data, outputs, _ = enc.encode_to_bytes(cfg, frames)
        coded = np.asarray(outputs["frame_coded"])
        total_bits = int(np.asarray(outputs["total_bits"])[coded].sum())
        y, cb, cr, parsed = decode_stream(data)
        assert len(parsed) == int(coded.sum()), (cfg, family)
        if cfg.emit_recon:
            rec = {k: np.asarray(outputs["recon_" + k])[coded]
                   for k in ("y", "cb", "cr")}
            assert np.array_equal(y, rec["y"]), (cfg, family)
            assert np.array_equal(cb, rec["cb"]), (cfg, family)
            assert np.array_equal(cr, rec["cr"]), (cfg, family)
        # resync of a CLEAN stream must equal the strict parse
        rs = parse.parse_stream(data, strict=False)
        assert len(rs) == len(parsed)
        for a, b in zip(parsed, rs):
            assert not b.damaged
            assert np.array_equal(a.levels, b.levels)
            assert np.array_equal(a.coded, b.coded)
        n += 1
        if n % 40 == 0:
            # every distinct config compiles fresh jit executables that
            # accumulate in-process; a ~20-minute run (155 configs) died
            # of allocator exhaustion without this (the persistent
            # on-disk cache keeps re-compiles cheap after clearing)
            jax.clear_caches()
        print(f"  ok {n}: {fmt.name} t={t} search={search} "
              f"rc={rate.bit_rate} seg={rate.mquant_segments} "
              f"ip={cfg.intra_period} fil={cfg.decisions.filter_with_mc} "
              f"recon={cfg.emit_recon} {family} "
              f"bits={total_bits}", file=sys.stderr, flush=True)
    print(f"encoder config fuzz: {n} configs, all contracts held, "
          f"{time.time() - t0:.0f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
