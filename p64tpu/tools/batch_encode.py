"""Multi-stream data-parallel batch encoder (BASELINE.json configs 4/5).

Encodes N independent input files as one sharded device batch:

  python -m p64tpu.tools.batch_encode -o outdir -q 10 'seq/*.y4m'
  python -m p64tpu.tools.batch_encode -o outdir -r 256000 a.y4m b.y4m ...

All streams must share one format and frame count (shorter inputs are
truncated to the common minimum).  Streams are sharded over every visible
device (p64tpu.distrib.mesh); per-stream .p64 files are written to outdir.
Under `jax.distributed` each host runs this on its local shard
(p64tpu.distrib.multihost).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..control.ratecontrol import RateConfig
from ..core import encoder as enc
from ..distrib import mesh as dm
from ..io import yuv


#: compiled sharded encoders keyed on (cfg, n_dev): a fresh jax.jit per
#: chunk would re-trace/re-compile every dispatch and defeat the pipelined
#: overlap entirely (round-3 review finding); one cached jit object serves
#: all chunks (equal-shape chunks hit its compilation cache).
#: Lifetime: process-long and unbounded BY DESIGN -- the CLI uses exactly
#: one (cfg, n_dev) key, and an entry pins its mesh + compiled executables,
#: so evicting and re-adding one would cost a retrace.  Library callers
#: cycling through many distinct configs should clear() between phases.
_ENCODER_CACHE: Dict[Tuple, object] = {}


def _dispatch_shard(cfg: enc.EncoderConfig, batch: Dict[str, np.ndarray]):
    """Launch the sharded device encode for a contiguous shard of streams.

    Returns (outputs, n): `outputs` are LAZY jax arrays (dispatch is
    asynchronous), so the caller can overlap further device dispatches with
    host serialization of earlier shards.  Device-side errors surface when
    the outputs are forced (in serialize_streams)."""
    import jax

    n = batch["y"].shape[0]
    n_dev = min(jax.device_count(), n)
    pad = (-n) % n_dev
    if pad:
        batch = {k: np.concatenate([v, np.repeat(v[-1:], pad, 0)])
                 for k, v in batch.items()}
    key = (cfg, n_dev)
    if key not in _ENCODER_CACHE:
        mesh = dm.make_mesh(n_dev)
        _ENCODER_CACHE[key] = (mesh, dm.make_sharded_encoder(cfg, mesh))
    mesh, run = _ENCODER_CACHE[key]
    # numpy straight into shard_batch: device_put with a NamedSharding
    # slices host memory per device; a jnp.asarray here would stage the
    # WHOLE batch through device 0's HBM first (round-4 review finding)
    frames = dm.shard_batch(mesh, batch)
    states = dm.shard_batch(mesh, dm.init_states(cfg, n + pad))
    _, outputs, _ = run(states, frames)
    return outputs, n


def encode_shard(cfg: enc.EncoderConfig,
                 batch: Dict[str, np.ndarray]) -> List[Tuple[bytes, int]]:
    """One sharded device dispatch over a contiguous shard of streams.

    Returns per-stream (bytes, nbits).  Streams are independent, so any
    sub-range of the batch produces byte-identical output to the same
    streams inside a larger dispatch -- the property the retry logic in
    encode_resilient relies on.
    """
    outputs, n = _dispatch_shard(cfg, batch)
    return dm.serialize_streams(cfg, outputs)[:n]


def encode_resilient(
        cfg: enc.EncoderConfig, batch: Dict[str, np.ndarray],
        retries: int = 2,
        fail_hook: Optional[Callable[[int, int, int], None]] = None,
        log: Callable[[str], None] = lambda s: None,
        chunk: int = 0,
) -> List[Optional[Tuple[bytes, int]]]:
    """Shard-level failure recovery (SURVEY section 5 "failure detection":
    per-shard re-dispatch is cheap because streams are independent).

    Encodes streams [0, n) via the sharded device encoder.  A failed
    dispatch (device error, preemption, transient runtime fault) is retried
    up to `retries` times; if a range keeps failing it is bisected so one
    poison stream cannot take down its neighbours.  Slots that still fail
    at width 1 are returned as None.  fail_hook(start, stop, attempt) is a
    test-only fault injector called before each dispatch; it raising ==
    that dispatch failing.

    chunk > 0 splits the batch into `chunk`-stream pieces and PIPELINES
    them: device dispatch is asynchronous, so while the host serializes
    chunk i the device already encodes chunk i+1 (SURVEY section 7 step 7
    "overlap finalize"; round-3 measurement: host finalize is ~43% of
    device time at 64 streams, so overlap hides most of it).  chunk == 0
    keeps the single-dispatch behavior.

    Fault-attribution caveat under pipelining: JAX defers device errors to
    the next sync point, so a fault raised by chunk i's computation can
    surface while forcing chunk i+1's outputs, charging a retry to the
    healthy neighbour.  Recovery still converges (both ranges re-dispatch,
    and re-dispatching a healthy range is byte-exact), but logs may
    misattribute the first failure and the retry budget is approximate
    across in-flight neighbours.
    """
    n = batch["y"].shape[0]
    results: List[Optional[Tuple[bytes, int]]] = [None] * n
    if chunk > 0:
        work = [(s, min(s + chunk, n), 0) for s in range(0, n, chunk)]
        work.reverse()          # .pop() serves ranges in ascending order
    else:
        work = [(0, n, 0)]      # (start, stop, attempt)

    def fail(s, e, att, exc):
        if att < retries:
            log(f"shard [{s},{e}) attempt {att} failed ({exc!r}); retrying")
            work.append((s, e, att + 1))
        elif e - s > 1:
            mid = (s + e) // 2
            log(f"shard [{s},{e}) failed {retries + 1} times; bisecting")
            work.append((mid, e, 0))
            work.append((s, mid, 0))
        else:
            log(f"stream {s} failed permanently: {exc!r}")

    inflight: List[Tuple[int, int, int, object, int]] = []  # FIFO, depth 2

    def drain_one():
        s, e, att, outputs, n_sub = inflight.pop(0)
        try:
            results[s:e] = dm.serialize_streams(cfg, outputs)[:n_sub]
        except Exception as exc:  # noqa: BLE001 -- forced device fault
            fail(s, e, att, exc)

    while work or inflight:
        while work and len(inflight) < 2:
            s, e, att = work.pop()
            try:
                if fail_hook is not None:
                    fail_hook(s, e, att)
                sub = {k: v[s:e] for k, v in batch.items()}
                outputs, n_sub = _dispatch_shard(cfg, sub)
            except Exception as exc:  # noqa: BLE001 -- dispatch-time fault
                fail(s, e, att, exc)
                continue
            inflight.append((s, e, att, outputs, n_sub))
        if inflight:
            drain_one()
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="p64tpu.tools.batch_encode")
    ap.add_argument("inputs", nargs="+", help="input files or globs (.y4m)")
    ap.add_argument("-o", "--outdir", required=True)
    ap.add_argument("-q", "--quant", type=int, default=8)
    ap.add_argument("-r", "--rate", type=int, default=0)
    ap.add_argument("-f", "--frame-rate", type=int, default=30)
    ap.add_argument("-i", "--search", type=int, default=15)
    ap.add_argument("--retries", type=int, default=2,
                    help="re-dispatch attempts per failed shard (then "
                         "bisect to isolate a poison stream)")
    ap.add_argument("--chunk", type=int, default=0,
                    help="streams per pipelined chunk (0 = one dispatch); "
                         "with chunking, host serialization of chunk i "
                         "overlaps device encode of chunk i+1")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    # persistent compile cache: repeat invocations skip the compile
    from ..utils import enable_compile_cache
    enable_compile_cache()
    if not 0 <= args.search <= 15:
        print(f"-i/--search must be 0..15 (H.261 MV range), got "
              f"{args.search}", file=sys.stderr)
        return 1

    from ..utils import expand_inputs
    paths: List[str] = expand_inputs(args.inputs)
    if not paths:
        print("no inputs", file=sys.stderr)
        return 1

    loaded = [yuv.load_input(p) for p in paths]
    fmt = loaded[0][1]
    if any(f is not fmt for _, f in loaded):
        print("all inputs must share one picture format", file=sys.stderr)
        return 1
    tmin = min(fr["y"].shape[0] for fr, _ in loaded)
    batch = {
        k: np.stack([fr[k][:tmin] for fr, _ in loaded])
        for k in ("y", "cb", "cr")
    }

    cfg = enc.EncoderConfig(
        fmt=fmt, search=max(args.search, 0), intra_only=args.search <= 0,
        # production batch encode never fetches recon planes; not emitting
        # them saves (T,H,W)x3 HBM per stream (EncoderConfig.emit_recon)
        emit_recon=False,
        rate=RateConfig(bit_rate=args.rate, frame_rate=args.frame_rate,
                        fixed_quant=args.quant))
    n = len(paths)
    t0 = time.time()
    streams = encode_resilient(
        cfg, batch, retries=args.retries, chunk=args.chunk,
        log=lambda s: print(f"batch_encode: {s}", file=sys.stderr))
    dt = time.time() - t0
    os.makedirs(args.outdir, exist_ok=True)
    failed = []
    total_bits = 0
    for path, res in zip(paths, streams):
        if res is None:
            failed.append(path)
            continue
        data, nbits = res
        total_bits += nbits
        out = os.path.join(
            args.outdir,
            os.path.splitext(os.path.basename(path))[0] + ".p64")
        with open(out, "wb") as f:
            f.write(data)
        if args.verbose:
            print(f"{out}: {nbits} bits")
    mbs = n * tmin * fmt.num_mbs
    print(f"{n} streams x {tmin} frames ({fmt.name}), {total_bits} total "
          f"bits, device time {dt:.2f}s ({mbs / dt:.0f} MB/s)")
    if failed:
        print(f"{len(failed)} stream(s) FAILED after retries: "
              + " ".join(failed), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
