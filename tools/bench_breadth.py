"""Benchmark breadth: all configs + stream-count scaling + decode + host
finalize.

Runs bench.measure over {cif, cif_rc, cif_intra, qcif}, a stream-count
scaling curve {4, 16, 32, 64} for the headline config, the decoder
benchmark, and a host-finalize timing at 64 streams, then prints a markdown
table (stderr prints progress; stdout the table).  Needs the GPU:

    python tools/bench_breadth.py
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402


def measure_finalize(streams: int = 64, frames_t: int = 8) -> dict:
    """Host serialize_streams cost at scale (round-2 verdict item 10): the
    per-stream C++ serializer calls run in a serial Python loop; measure
    whether they rival device time at 64 streams."""
    import jax
    import jax.numpy as jnp
    from p64tpu.control.ratecontrol import RateConfig
    from p64tpu.core import encoder as enc
    from p64tpu.entropy.encode import serialize_sequence
    from p64tpu.spec.constants import CIF

    bench._enable_cache(jax)
    cfg = enc.EncoderConfig(fmt=CIF, search=15,
                            rate=RateConfig(fixed_quant=10))
    frames = bench.make_content(CIF, streams, frames_t)
    states = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (streams,) + x.shape),
        enc.init_state(cfg))
    import numpy as np
    _, outputs = jax.jit(jax.vmap(
        lambda s, f: enc.encode_sequence(cfg, f, s)))(states, frames)
    outputs = {k: np.asarray(v) for k, v in outputs.items()}
    best = float("inf")
    nbytes = 0
    for _ in range(3):
        t0 = time.time()
        nbytes = 0
        for s in range(streams):
            syms = enc.outputs_to_symbols(
                cfg, {k: v[s] for k, v in outputs.items()})
            data, _ = serialize_sequence(cfg.fmt, syms)
            nbytes += len(data)
        best = min(best, time.time() - t0)
    return dict(streams=streams, ms=best * 1e3, bytes=nbytes)


def main() -> int:
    only = sys.argv[1:] or None       # e.g. `bench_breadth.py knee pipeline`

    def want(tag):
        return only is None or tag in only

    rows = []
    if want("configs"):
        for config in ("cif", "cif_rc", "cif_intra", "qcif"):
            r = bench.measure(config)
            rows.append((f"{config} (16 streams)", r))
    if want("scaling") or want("knee"):
        counts = [4, 32, 64] if want("scaling") else []
        if want("knee"):
            # round-3 verdict item 5: find the knee (first pass measured
            # 128: 906k > 64: 668k > 256: 850k; refine around the peak)
            counts += [96, 128, 192, 256]
        for streams in counts:
            try:
                r = bench.measure("cif", streams=streams)
            except Exception as e:    # noqa: BLE001 -- record OOM as data
                print(f"| cif ({streams} streams) | FAILED: "
                      f"{type(e).__name__}: {str(e)[:120]} |")
                break
            rows.append((f"cif ({streams} streams)", r))
    if want("reconab"):
        # round-4 verdict weak #5 / item 4: does dropping the per-frame
        # recon outputs (~0.9 GB HBM at 128 streams) move the knee?
        for er in (True, False):
            r = bench.measure("cif", streams=128, emit_recon=er)
            rows.append((f"cif (128 streams, emit_recon={er})", r))
    if want("decode"):
        rows.append(("decode (16 streams)", bench.measure_decode()))
    if want("pipeline"):
        rows.append(("pipeline (64 streams)", bench.measure_pipeline()))
    if want("pipeline128"):
        # the production batch point (round-4 verdict item 4): pipeline at
        # the measured 128-stream knee, recon off, two chunkings
        for chunk in (16, 32):
            r = bench.measure_pipeline(streams=128, chunk=chunk,
                                       emit_recon=False)
            rows.append((f"pipeline (128 streams, chunk {chunk}, "
                         f"recon off)", r))

    print("| config | MB/s/chip | ms/run | total bits | compile s |")
    print("|---|---|---|---|---|")
    for name, r in rows:
        extra = ""
        if "parse_ms" in r:
            extra = (f" (stages: parse {r['parse_ms']:.0f} + device "
                     f"{r['device_ms']:.0f}; "
                     f"{r['overlap_hidden'] * 100:.0f}% parse hidden)")
        elif "finalize_ms" in r:
            extra = (f" (stages: device {r['device_ms']:.0f} + finalize "
                     f"{r['finalize_ms']:.0f}; "
                     f"{r['overlap_hidden'] * 100:.0f}% finalize hidden)")
        print(f"| {name} | {r['mbs']:,.0f} | {r['ms']:.1f}{extra} "
              f"| {r['bits']} | {r.get('compile_s', float('nan')):.0f} |")

    if want("finalize"):
        f = measure_finalize()
        print(f"\nhost finalize: {f['streams']} CIF streams x 8 frames = "
              f"{f['ms']:.1f} ms host-serial ({f['bytes']} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
