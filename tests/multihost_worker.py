"""Subprocess worker for the 2-process `jax.distributed` test (NOT collected
by pytest -- no test_ prefix).  Each process plays one "host": it initializes
the distributed runtime, feeds only its LOCAL shard of streams, runs the
global sharded encoder (collectives ride Gloo on CPU, NCCL on GPUs),
serializes its local bitstreams, and allgathers per-stream bit lengths.

Usage: python multihost_worker.py <process_id> <num_processes> <port> \
           <out.json> [local_devices]
"""

import hashlib
import json
import os
import sys

LOCAL_DEVICES = 4       # default; arg 5 overrides (4-process variant uses 2)
GLOBAL_STREAMS = 8
FRAMES_T = 3
# production config (round-2 verdict weak #5: the 2-process path used to run
# search=2): full +/-15 search + rate control, same as the single-process
# 8-device mesh test
SEARCH = 15


def make_global_frames():
    """Deterministic content every process can regenerate (seed-shared)."""
    import numpy as np
    rng = np.random.default_rng(20260820)
    h, w = 144, 176
    y = (rng.integers(0, 256, (GLOBAL_STREAMS, FRAMES_T, h, w)) // 4 + 96
         ).astype(np.uint8)
    cb = rng.integers(60, 200, (GLOBAL_STREAMS, FRAMES_T, h // 2, w // 2)
                      ).astype(np.uint8)
    cr = rng.integers(60, 200, (GLOBAL_STREAMS, FRAMES_T, h // 2, w // 2)
                      ).astype(np.uint8)
    return dict(y=y, cb=cb, cr=cr)


def main() -> int:
    pid, nproc, port, out_path = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], sys.argv[4])
    local_devices = int(sys.argv[5]) if len(sys.argv) > 5 else LOCAL_DEVICES
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={local_devices}")
    import jax
    jax.config.update("jax_platforms", "cpu")

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    from p64tpu.utils import enable_compile_cache
    enable_compile_cache()
    from p64tpu.control.ratecontrol import RateConfig
    from p64tpu.core import encoder as enc
    from p64tpu.distrib import mesh as dm
    from p64tpu.distrib import multihost as mh
    from p64tpu.spec.constants import QCIF

    mh.initialize(f"127.0.0.1:{port}", nproc, pid)
    assert jax.process_count() == nproc, jax.process_count()
    assert jax.device_count() == nproc * local_devices

    import jax.numpy as jnp
    cfg = enc.EncoderConfig(fmt=QCIF, search=SEARCH,
                            rate=RateConfig(bit_rate=192_000, frame_rate=30))
    n_local = GLOBAL_STREAMS // nproc
    frames = make_global_frames()
    lo = pid * n_local
    local_frames = {k: jnp.asarray(v[lo:lo + n_local])
                    for k, v in frames.items()}

    mesh = mh.global_mesh()
    _, outputs, agg = mh.encode_global(cfg, mesh, local_frames)
    streams = mh.finalize_local(cfg, outputs)
    assert len(streams) == n_local, len(streams)
    lengths = mh.gather_stream_lengths([n for _, n in streams])

    with open(out_path, "w") as f:
        json.dump({
            "pid": pid,
            "global_devices": jax.device_count(),
            "total_bits": dm.agg_total_bits(agg),
            "frames_coded": int(agg["frames_coded"]),
            "local_sha": [hashlib.sha256(d).hexdigest() for d, _ in streams],
            "local_bits": [n for _, n in streams],
            "gathered_lengths": [int(x) for x in lengths],
        }, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
