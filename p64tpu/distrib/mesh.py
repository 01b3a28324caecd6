"""Data-parallel scale-out: independent streams sharded over a device mesh.

Reference reality: NONE -- the reference is a single-threaded scalar C
program with no parallelism of any kind (SURVEY section 2 "parallelism
inventory").  This codec's scaling story, per SURVEY/BASELINE, is:

  * the ONLY parallel axis with an analogue in this workload is data
    parallelism over independent streams/GOPs (the frame-recursive
    reconstruction dependency forbids splitting one stream's time axis
    across chips; there are no weights, so TP/PP/EP/CP/ring-attention have
    no analogue -- documented here so nobody builds them);
  * within a stream, parallelism comes from batching all MBs of a frame
    through the kernels (already done in core.encoder).

Implementation: `jax.sharding.Mesh` with a single "streams" axis;
`shard_map` runs the per-shard vmapped encoder and uses `psum` across the
devices for the aggregate rate/distortion statistics (the reference's stat.c totals).
Per-shard variable-length bitstreams are serialized host-side per shard and
concatenated -- merging bytes is host work by design (SURVEY section 7).
Multi-host: the same code runs under `jax.distributed.initialize`; each host
feeds its local shard of streams and serializes its local outputs.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core import encoder as enc

STREAM_AXIS = "streams"


def make_mesh(n_devices: Optional[int] = None,
              devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (STREAM_AXIS,))


def init_states(cfg: enc.EncoderConfig, n_streams: int):
    """Batched per-stream encoder state (leading axis = stream)."""
    one = enc.init_state(cfg)
    return jax.tree.map(
        lambda x: jnp.broadcast_to(x, (n_streams,) + x.shape), one)


def _batched_encode(cfg: enc.EncoderConfig, states, frames):
    st, out = jax.vmap(lambda s, f: enc.encode_sequence(cfg, f, s))(
        states, frames)
    return st, out


def make_sharded_encoder(cfg: enc.EncoderConfig, mesh: Mesh):
    """Build a jitted multi-stream encoder sharded over `mesh`.

    Returns fn(states, frames) -> (states', outputs, agg) where states /
    frames / outputs carry a leading stream axis sharded across devices and
    agg is a replicated dict of aggregate stats (psum over the mesh):
    total_bits, total_sse_y, frames_coded.
    """
    shard = P(STREAM_AXIS)

    # check_vma=False: the per-stream encoder mixes replicated constants
    # (VLC LUTs, zero initializers) with stream-varying data throughout;
    # JAX 0.9's varying-manual-axes checker flags those adds even though
    # the program is embarrassingly parallel (the only cross-device
    # communication is the explicit psum below).
    @functools.partial(
        jax.shard_map, mesh=mesh, check_vma=False,
        in_specs=(shard, shard), out_specs=(shard, shard, P()))
    def run(states, frames):
        st, out = _batched_encode(cfg, states, frames)
        # aggregate bits as a 15-bit-split int32 pair: a single int32 sum
        # wrapped past 2^31 total bits (~268 MB of streams per dispatch,
        # reachable at the tool's target scale -- round-4 review finding;
        # int64 needs x64 mode).  Per-STREAM totals are int32-safe (one
        # stream per dispatch < 268 MB by construction); the split pair
        # is exact up to ~2^46 total bits.  Recombine with
        # agg_total_bits().
        per_stream = out["total_bits"].sum(axis=-1)
        agg = dict(
            total_bits_lo=jax.lax.psum((per_stream & 32767).sum(),
                                       STREAM_AXIS),
            total_bits_hi=jax.lax.psum((per_stream >> 15).sum(),
                                       STREAM_AXIS),
            total_sse_y=jax.lax.psum(out["sse_y"].sum(), STREAM_AXIS),
            frames_coded=jax.lax.psum(
                out["frame_coded"].sum().astype(jnp.int32), STREAM_AXIS),
        )
        return st, out, agg

    return jax.jit(run)


def agg_total_bits(agg) -> int:
    """Exact aggregate bit count from the split int32 psum pair."""
    return (int(agg["total_bits_hi"]) << 15) + int(agg["total_bits_lo"])


def shard_batch(mesh: Mesh, tree):
    """Device-put a host batch with the stream axis sharded over the mesh."""
    sharding = NamedSharding(mesh, P(STREAM_AXIS))
    return jax.tree.map(lambda x: jax.device_put(x, sharding), tree)


def serialize_streams(cfg: enc.EncoderConfig,
                      outputs) -> List[Tuple[bytes, int]]:
    """Host finalize for a multi-stream batch: per-stream (bytes, nbits).

    outputs: the sharded/batched encoder outputs (leading stream axis).

    Fanned across a thread pool (see utils.fan_map -- the ctypes C++
    serializer releases the GIL).
    """
    from ..entropy.encode import serialize_sequence
    from ..native import load
    from ..utils import fan_map
    host: Dict[str, np.ndarray] = {
        k: np.asarray(v) for k, v in outputs.items()
        if k not in ("recon_y", "recon_cb", "recon_cr")}
    n_streams = host["frame_coded"].shape[0]

    def one(s: int) -> Tuple[bytes, int]:
        stream_out = {k: v[s] for k, v in host.items()}
        syms = enc.outputs_to_symbols(cfg, stream_out)
        return serialize_sequence(cfg.fmt, syms)

    load()  # build/load the native engine once before fanning out
    return fan_map(one, range(n_streams))
