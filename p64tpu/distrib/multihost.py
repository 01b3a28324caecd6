"""Multi-host orchestration glue (SURVEY section 5 "communication backend").

The reference has no distributed anything; this codec's multi-host story
is JAX's native runtime: `jax.distributed.initialize` + a global mesh over
all devices, with the same shard_map program as single-host
(p64tpu.distrib.mesh).  Per-host duties:

  * feed the LOCAL shard of streams (addressable devices only),
  * run the global jitted encoder (XLA routes the psum between devices),
  * serialize the local shard's bitstreams on the local host,
  * exchange only scalar stats + per-stream byte lengths via
    `multihost_utils.process_allgather`; bitstream BYTES stay host-local
    (variable-length; written per-host and concatenated by job tooling).

This module cannot be exercised on single-host CI; its mesh/sharding
structure is identical to what tests/test_distrib.py validates on the
8-virtual-device CPU mesh, and `__graft_entry__.dryrun_multichip` dry-runs
the full program.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import jax

from ..core import encoder as enc
from . import mesh as dm


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """jax.distributed.initialize passthrough (no-op if single process)."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


#: compiled global encoders keyed on (cfg, mesh); process-long by design
#: (see batch_encode._ENCODER_CACHE for the lifetime rationale)
_GLOBAL_ENCODER_CACHE: Dict = {}


def global_mesh() -> "jax.sharding.Mesh":
    """Mesh over ALL devices (all hosts) on the streams axis."""
    return dm.make_mesh(devices=jax.devices())


def encode_global(cfg: enc.EncoderConfig, mesh, local_frames: Dict,
                  states=None):
    """Run the global sharded encoder with per-host local inputs.

    local_frames: this host's shard, leading axis = local stream count
    (n_global_streams / process_count).  Uses
    `multihost_utils.host_local_array_to_global_array` so each host only
    materializes its own slice.
    """
    from jax.experimental import multihost_utils as mh
    from jax.sharding import PartitionSpec as P

    spec = P(dm.STREAM_AXIS)
    n_local = local_frames["y"].shape[0]
    n_global = n_local * jax.process_count()
    if states is None:
        states = dm.init_states(cfg, n_local)
    if jax.process_count() > 1:
        frames_g = jax.tree.map(
            lambda x: mh.host_local_array_to_global_array(x, mesh, spec),
            local_frames)
        states_g = jax.tree.map(
            lambda x: mh.host_local_array_to_global_array(
                np.asarray(x), mesh, spec), states)
    else:
        frames_g = dm.shard_batch(mesh, local_frames)
        states_g = dm.shard_batch(mesh, states)
    key = (cfg, mesh)
    if key not in _GLOBAL_ENCODER_CACHE:
        # a fresh jit per call would re-trace/re-compile every invocation
        # (the round-3 finding batch_encode._ENCODER_CACHE fixed; same
        # treatment here for driver loops calling encode_global per chunk)
        _GLOBAL_ENCODER_CACHE[key] = dm.make_sharded_encoder(cfg, mesh)
    run = _GLOBAL_ENCODER_CACHE[key]
    new_states, outputs, agg = run(states_g, frames_g)
    del n_global
    return new_states, outputs, agg


def _local_shard(x) -> np.ndarray:
    """Assemble this host's full slice of a global array: concatenate ALL
    addressable per-device shards in stream order (a host usually holds
    several devices, each with its own shard -- `addressable_data(0)` alone
    would drop every stream but the first device's)."""
    if jax.process_count() <= 1 or not hasattr(x, "addressable_shards"):
        return np.asarray(x)
    shards = sorted(x.addressable_shards,
                    key=lambda s: s.index[0].start or 0)
    # A replicated array would present one identical full-range shard per
    # local device; blind concatenation would duplicate every stream.  Only
    # axis-0-partitioned (disjoint, contiguous) arrays belong here.
    starts = [s.index[0].start or 0 for s in shards]
    stops = [s.index[0].stop if s.index[0].stop is not None
             else np.asarray(s.data).shape[0] for s in shards]
    if len(set(starts)) != len(starts):
        # duplicate starts are only safe when FULLY replicated (every shard
        # spans the identical range) -- a partially-replicated layout would
        # silently drop streams if we just took shards[0]
        if not (len(set(starts)) == 1 and len(set(stops)) == 1):
            # data-integrity check: must survive `python -O` (a silent
            # drop/duplicate of streams is worse than a crash)
            raise ValueError(
                f"_local_shard: mixed/partial replication "
                f"{list(zip(starts, stops))}")
        return np.asarray(shards[0].data)
    if not all(stops[i] <= starts[i + 1] for i in range(len(starts) - 1)):
        raise ValueError(
            f"_local_shard expects disjoint axis-0 shards, got "
            f"{list(zip(starts, stops))}")
    return np.concatenate([np.asarray(s.data) for s in shards], axis=0)


def finalize_local(cfg: enc.EncoderConfig, outputs) -> List[Tuple[bytes, int]]:
    """Serialize this host's addressable shard of the outputs."""
    local = jax.tree.map(_local_shard, outputs)
    return dm.serialize_streams(cfg, local)


def gather_stream_lengths(lengths: List[int]) -> np.ndarray:
    """All-gather per-stream bit lengths across hosts (scalar metadata only;
    bytes never cross hosts)."""
    from jax.experimental import multihost_utils as mh
    arr = np.asarray(lengths, np.int64)
    if jax.process_count() == 1:
        return arr
    return np.asarray(mh.process_allgather(arr)).reshape(-1)
