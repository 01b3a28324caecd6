"""Smoke test of the codec on the GPU, through the entry points users call.

  python chip_smoke.py              # one card: every phase below
  python chip_smoke.py --cards 4    # four cards: the sharded path only

Phases on one card (any failure exits non-zero; nothing is passed over):

  1. device    platform, device kind, count, JAX version, nvidia-smi name
               and power limit; the native C++ engine must load
  2. parity    every SAD formulation at CIF (288x352) with search 15,
               full_search tie-breaks, fdct/fdct_zz/idct and block_bits,
               each against its int64 oracle; memory analysis of the CIF
               encode step
  3. pins      the pinned streams re-encoded here equal the pins byte for
               byte (the CPU tests hold the CPU to the same pins)
  4. main path 64 CIF streams of 32 frames made from a seed, encoded by
               batch_encode and decoded by batch_decode; one stream through
               the CLI with rate control; decode must equal the encoder's
               reconstruction and the serializer's bits the device model

With --cards 4: 128 CIF streams encoded on a 4-device mesh and on one
device in the same process must give identical bytes, the psum aggregates
must equal the per-stream sums, and multihost.encode_global +
finalize_local over the 4 cards must give the same bytes again.

The last line of stdout is {"ok": true, "device": {...}}.  Times printed
here are information, not a benchmark.  Needs a GPU; fails at once without.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
CIF_H, CIF_W = 288, 352


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    """nvidia-smi's name and power limit, one entry per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return " | ".join(line.strip() for line in out.splitlines())


def make_streams(n: int, t: int, seed: int):
    """n CIF sequences of t frames: a smooth random texture panning at a
    per-stream velocity, a bright square moving across it, and noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:CIF_H, 0:CIF_W]
    out = []
    for _ in range(n):
        m = 4 * t                      # room for the pan
        coarse = rng.integers(30, 200, ((CIF_H + 2 * m) // 16 + 1,
                                        (CIF_W + 2 * m) // 16 + 1))
        tex = np.kron(coarse, np.ones((16, 16), np.int64))
        vy, vx = rng.integers(-4, 5, 2)
        sy, sx = rng.integers(0, 200, 2)
        y = np.empty((t, CIF_H, CIF_W), np.uint8)
        for i in range(t):
            f = tex[m + vy * i:m + vy * i + CIF_H,
                    m + vx * i:m + vx * i + CIF_W]
            f = f + ((xx * 3 + yy * 2) // 8) % 24
            y0, x0 = (sy + 5 * i) % (CIF_H - 48), (sx + 7 * i) % (CIF_W - 48)
            f[y0:y0 + 48, x0:x0 + 48] += 40
            y[i] = np.clip(f + rng.integers(0, 6, f.shape), 0, 255)
        cb = (y[:, ::2, ::2] // 2 + 64).astype(np.uint8)
        cr = (255 - y[:, 1::2, ::2] // 2).astype(np.uint8)
        out.append(dict(y=y, cb=cb, cr=cr))
    return out


def phase_device(jax, cards: int) -> None:
    d = jax.devices()[0]
    log(f"device: platform {d.platform}, kind {d.device_kind}, count "
        f"{len(jax.devices())}, jax {jax.__version__}")
    check(d.platform == "gpu", f"needs a GPU, JAX found {d.platform}")
    check(len(jax.devices()) >= cards,
          f"needs {cards} cards, JAX found {len(jax.devices())}")
    log(f"card: {card_line()}")
    from p64tpu.native import load
    check(load() is not None, "native C++ engine did not build or load")
    log("native C++ engine: loaded")


def phase_parity(jax) -> None:
    import jax.numpy as jnp

    from p64tpu.control.ratecontrol import RateConfig
    from p64tpu.core import encoder as enc
    from p64tpu.distrib import mesh as dm
    from p64tpu.kernels.dispatch import current_sad_formulation
    from p64tpu.spec.constants import CIF
    from p64tpu.tools import parity

    log(f"SAD formulation on this platform: {current_sad_formulation()}")
    t0 = time.time()
    check(parity.check_sad(CIF_H, CIF_W, 15, log=log), "SAD parity")
    check(parity.check_dct(4096, log=log), "DCT parity")
    check(parity.check_block_bits(4096, log=log), "block_bits parity")
    log(f"parity phase: {time.time() - t0:.1f}s")

    cfg = enc.EncoderConfig(fmt=CIF, search=15,
                            rate=RateConfig(fixed_quant=10))
    n = 16
    states = dm.init_states(cfg, n)
    frame = dict(y=jnp.zeros((n, CIF_H, CIF_W), jnp.uint8),
                 cb=jnp.zeros((n, CIF_H // 2, CIF_W // 2), jnp.uint8),
                 cr=jnp.zeros((n, CIF_H // 2, CIF_W // 2), jnp.uint8))
    step = jax.jit(jax.vmap(lambda s, f: enc.encode_frame_step(cfg, s, f)))
    t0 = time.time()
    compiled = step.lower(states, frame).compile()
    log(f"CIF encode step, {n} streams, compile {time.time() - t0:.1f}s, "
        f"memory analysis: {compiled.memory_analysis()}")


def phase_pins() -> None:
    from p64tpu.tools import parity
    check(parity.check_pins(log=log), "pinned streams differ")


def _write_inputs(tmp: str, n: int, t: int):
    from p64tpu.io import yuv
    seqs = make_streams(n, t, SEED)
    paths = []
    for i, s in enumerate(seqs):
        p = os.path.join(tmp, f"s{i:03d}.y4m")
        yuv.write_y4m(p, s, (30, 1))
        paths.append(p)
    return seqs, paths


def phase_main_path(jax, label: str, n: int = 64, t: int = 32) -> None:
    from p64tpu import cli
    from p64tpu.control.ratecontrol import RateConfig
    from p64tpu.control.decisions import DecisionConfig
    from p64tpu.core import encoder as enc
    from p64tpu.distrib import mesh as dm
    from p64tpu.io import yuv
    from p64tpu.spec.constants import CIF
    from p64tpu.tools import batch_decode, batch_encode

    q, chunk = 10, min(16, n)
    dev = jax.devices()[0]
    with tempfile.TemporaryDirectory(prefix="p64smoke_") as tmp:
        t0 = time.time()
        seqs, paths = _write_inputs(tmp, n, t)
        log(f"inputs: {n} CIF y4m files x {t} frames ({time.time() - t0:.1f}s)")
        enc_dir = os.path.join(tmp, "enc")
        dec_dir = os.path.join(tmp, "dec")
        argv = ["-o", enc_dir, "-q", str(q), "--chunk", str(chunk), *paths]
        walls = []
        for _ in range(2):       # cold (compile included), then warm
            t0 = time.time()
            check(batch_encode.main(argv) == 0, "batch_encode failed")
            walls.append(time.time() - t0)
        mbs = n * t * CIF.num_mbs
        log(f"batch_encode {n}x{t} CIF q{q}: compile_s {walls[0] - walls[1]:.1f}, "
            f"warm wall {walls[1]:.2f}s, {mbs / walls[1]:.0f} MB/s [{label}]")
        enc_files = sorted(os.listdir(enc_dir))
        check(len(enc_files) == n, f"{len(enc_files)} of {n} streams encoded")

        walls = []
        for _ in range(2):
            t0 = time.time()
            check(batch_decode.main(["-o", dec_dir] + [
                os.path.join(enc_dir, f) for f in enc_files]) == 0,
                "batch_decode failed")
            walls.append(time.time() - t0)
        log(f"batch_decode {n}x{t} CIF: compile_s {walls[0] - walls[1]:.1f}, "
            f"warm wall {walls[1]:.2f}s, {mbs / walls[1]:.0f} MB/s [{label}]")

        # the encoder's own view of the same streams: bytes, device bit
        # model and reconstruction (one more compile, with recon emitted)
        cfg = enc.EncoderConfig(fmt=CIF, search=15, emit_recon=True,
                                rate=RateConfig(fixed_quant=q))
        batch = {k: np.stack([s[k] for s in seqs]) for k in ("y", "cb", "cr")}
        bad = []
        for s0 in range(0, n, chunk):
            outputs, m = batch_encode._dispatch_shard(
                cfg, {k: v[s0:s0 + chunk] for k, v in batch.items()})
            host = {k: np.asarray(v) for k, v in outputs.items()}
            for j, (data, nbits) in enumerate(
                    dm.serialize_streams(cfg, outputs)[:m]):
                i = s0 + j
                with open(os.path.join(enc_dir, f"s{i:03d}.p64"), "rb") as f:
                    ok = f.read() == data
                ok &= nbits == int(host["total_bits"][j].sum())
                dec, _ = yuv.read_y4m(os.path.join(dec_dir, f"s{i:03d}.y4m"))
                for k in ("y", "cb", "cr"):
                    ok &= np.array_equal(dec[k], host["recon_" + k][j])
                if not ok:
                    bad.append(i)
        check(not bad, f"streams {bad}: bytes, bits or decode differ from "
              f"the encoder")
        log(f"{n} streams: batch_encode bytes == encoder, serializer bits "
            f"== device bit model, batch_decode planes == encoder "
            f"reconstruction")

        # one stream through the CLI, rate-controlled with MQUANT segments
        src = paths[0]
        p64 = os.path.join(tmp, "cli.p64")
        out = os.path.join(tmp, "cli.y4m")
        t0 = time.time()
        check(cli.main(["-s", p64, "-r", "1024000", "-m", "3", "-v", src])
              == 0, "CLI encode failed")
        log(f"CLI encode: {time.time() - t0:.1f}s")
        check(cli.main(["-d", "-s", p64, "-o", out]) == 0,
              "CLI decode failed")
        frames, fmt = yuv.load_input(src)
        import jax.numpy as jnp
        cfg = enc.EncoderConfig(
            fmt=fmt, search=15, intra_only=False, intra_period=0,
            decisions=DecisionConfig(filter_with_mc=True),
            rate=RateConfig(bit_rate=1024000, frame_rate=30, fixed_quant=8,
                            mquant_segments=3))
        data, outputs, _ = enc.encode_to_bytes(
            cfg, {k: jnp.asarray(v) for k, v in frames.items()})
        with open(p64, "rb") as f:
            check(f.read() == data, "CLI stream differs from the encoder")
        dec, _ = yuv.read_y4m(out)
        coded = np.asarray(outputs["frame_coded"]).astype(bool)
        for k in ("y", "cb", "cr"):
            check(np.array_equal(dec[k],
                                 np.asarray(outputs["recon_" + k])[coded]),
                  f"CLI decode {k} differs from the encoder's reconstruction")
        log(f"CLI: rate-controlled stream ({len(data)} bytes, "
            f"{int(coded.sum())}/{t} frames coded) decodes to the encoder's "
            f"reconstruction")
    stats = dev.memory_stats() or {}
    log(f"peak device memory: "
        f"{stats.get('peak_bytes_in_use', 0) / 2**30:.2f} GiB [{label}]")


def phase_cards(jax, cards: int, label: str, n: int = 128,
                t: int = 16) -> None:
    from p64tpu.control.ratecontrol import RateConfig
    from p64tpu.core import encoder as enc
    from p64tpu.distrib import mesh as dm
    from p64tpu.distrib import multihost as mh
    from p64tpu.spec.constants import CIF

    seqs = make_streams(n, t, SEED)
    batch = {k: np.stack([s[k] for s in seqs]) for k in ("y", "cb", "cr")}
    cfg = enc.EncoderConfig(fmt=CIF, search=15,
                            rate=RateConfig(fixed_quant=10))
    results = {}
    for name, devs in ((f"{cards} cards", jax.devices()[:cards]),
                       ("1 card", jax.devices()[:1])):
        mesh = dm.make_mesh(devices=devs)
        run = dm.make_sharded_encoder(cfg, mesh)
        states = dm.shard_batch(mesh, dm.init_states(cfg, n))
        frames = dm.shard_batch(mesh, batch)
        t0 = time.time()
        _, outputs, agg = run(states, frames)
        jax.block_until_ready(outputs)
        t_first = time.time() - t0
        t0 = time.time()
        _, outputs, agg = run(states, frames)
        jax.block_until_ready((outputs, agg))
        wall = time.time() - t0
        streams = dm.serialize_streams(cfg, outputs)
        host = {k: np.asarray(v) for k, v in outputs.items()}
        check(dm.agg_total_bits(agg) == sum(b for _, b in streams)
              == int(host["total_bits"].sum()),
              f"{name}: psum total_bits != per-stream sum")
        # sse_y is a float32 statistic: sums taken in another order may
        # differ by the float32 summation bound, n_terms * 2^-24 relative
        sse = host["sse_y"].astype(np.float64).sum()
        check(abs(float(agg["total_sse_y"]) - sse)
              <= host["sse_y"].size * 2.0 ** -24 * sse,
              f"{name}: psum sse {float(agg['total_sse_y'])} != "
              f"per-stream sum {sse}")
        check(int(agg["frames_coded"]) == int(host["frame_coded"].sum()),
              f"{name}: psum frames_coded != per-stream sum")
        results[name] = [d for d, _ in streams]
        log(f"{name}: {n} CIF streams x {t} frames, first run "
            f"{t_first:.1f}s, warm {wall:.2f}s, "
            f"{n * t * CIF.num_mbs / wall:.0f} MB/s, aggregates == "
            f"per-stream sums [{label}]")
    a, b = results.values()
    check(a == b, f"{cards}-card bytes differ from 1-card bytes")
    log(f"{cards}-card and 1-card streams byte-identical ({n} streams)")

    mh.initialize()                  # one process: a no-op by design
    _, outputs, agg = mh.encode_global(cfg, mh.global_mesh(), batch)
    streams = mh.finalize_local(cfg, outputs)
    check([d for d, _ in streams] == a, "multihost bytes differ")
    check(dm.agg_total_bits(agg) == sum(b for _, b in streams),
          "multihost psum total_bits != per-stream sum")
    log(f"multihost.encode_global + finalize_local over "
        f"{len(mh.global_mesh().devices)} cards: byte-identical, aggregates "
        f"== per-stream sums")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded 4-card path")
    args = ap.parse_args(argv)

    import jax
    if jax.devices()[0].platform != "gpu":
        fail(f"needs a GPU, JAX found {jax.devices()[0].platform}")
    sys.path.insert(0, REPO)
    from p64tpu.utils import enable_compile_cache
    enable_compile_cache()

    t_start = time.time()
    phase_device(jax, args.cards)
    label = card_line()
    if args.cards == 4:
        phase_cards(jax, 4, label)
    else:
        phase_parity(jax)
        phase_pins()
        phase_main_path(jax, label)
    log(f"chip_smoke: all phases passed in {time.time() - t_start:.0f}s")
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
