"""Per-stream checkpoint / resume.

Reference reality: none -- a crashed encode restarts from frame 0 (SURVEY
section 5).  The codec-domain analogue this codec implements: encoder
state is tiny (reconstructed reference planes + refresh counters + buffer +
frame index), so any frame boundary is a resume point.  A checkpoint holds
the per-stream state plus the bytes of each per-stream bitstream emitted so
far; `resume` reloads the state and the encoder simply continues -- the
concatenated bitstream is identical to an uninterrupted run (tested in
tests/test_checkpoint.py).

Crash safety: everything (state arrays, stream bytes, meta) lives in ONE
.npz published by a single fsync'd os.replace, so state<->bits pairing is
atomic by construction.  The previous layout used three files replaced in
sequence; a round-4 advisor finding showed a crash between the replaces
could pair NEW stream bytes with OLD state (resume would then re-encode
frames already in the bitstream, duplicating them) -- a whole class of bug
the single-file design removes rather than detects.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import jax.numpy as jnp

# state keys are stored under this prefix so they can never collide with
# the checkpoint's own bookkeeping entries below
_STATE = "state/"
_BITS = "__bits__"
_LENS = "__bits_lengths__"
_META = "__meta_json__"


def save(path: str, state, streams: Optional[List[bytes]] = None,
         meta: Optional[Dict] = None) -> None:
    """Persist encoder state (single- or multi-stream pytree dict).

    Atomic and power-loss-safe: one temp file, fsync'd, then one
    os.replace, then the directory fsync'd -- either the old checkpoint
    or the complete new one exists, never a mix."""
    payload = {_STATE + k: np.asarray(v) for k, v in state.items()}
    if streams is not None:
        payload[_LENS] = np.asarray([len(s) for s in streams], np.int64)
        payload[_BITS] = np.frombuffer(b"".join(streams), np.uint8)
    payload[_META] = np.frombuffer(
        json.dumps(meta or {}).encode(), np.uint8)

    tmp = path + ".npz.tmp.npz"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path + ".npz")
    dirfd = os.open(os.path.dirname(os.path.abspath(path)) or ".",
                    os.O_RDONLY)
    try:
        os.fsync(dirfd)
    finally:
        os.close(dirfd)
    # hygiene: drop companions left by the pre-round-5 three-file layout
    # (load() never reads them, but a stale .bits invites confusion)
    for ext in (".bits", ".json"):
        if os.path.exists(path + ext):
            os.remove(path + ext)


def load(path: str) -> Tuple[Dict[str, jnp.ndarray], List[bytes], Dict]:
    """Returns (state, per-stream bytes so far, meta)."""
    with np.load(path + ".npz") as z:
        state = {k[len(_STATE):]: jnp.asarray(z[k]) for k in z.files
                 if k.startswith(_STATE)}
        if not state:
            # round-5 review finding: a pre-round-5 three-file checkpoint
            # (bare state keys, companion .bits/.json) would silently load
            # as EMPTY state and a resume would re-encode from frame 0 --
            # the exact failure class this module exists to prevent
            raise ValueError(
                f"{path}.npz is not a single-file p64tpu checkpoint "
                f"(no 'state/' keys -- pre-round-5 layout? re-save with "
                f"the current version)")
        meta = json.loads(z[_META].tobytes().decode()) if _META in z.files \
            else {}
        streams: List[bytes] = []
        if _LENS in z.files:
            blob = z[_BITS].tobytes()
            off = 0
            for l in z[_LENS]:
                streams.append(blob[off:off + int(l)])
                off += int(l)
    return state, streams, meta
