"""H.261 decoder: host VLC parse -> batched device reconstruction.

Mirror of SURVEY section 3b (p64DecodeSequence/Frame/GOB/MDU, unverified):
the bit-serial parse happens on host (p64tpu.entropy.parse or the C++
parser), producing dense per-frame symbol tensors; everything numeric
(dequant, IDCT, MC, loop filter, add, clip) runs as one jitted `lax.scan`
over frames using the SAME reconstruction code the encoder uses for its
local decode -- so encoder recon and decoder output are bit-identical by
construction.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..entropy.parse import ParsedFrame, parse_stream
from ..spec.constants import Format
from .reconstruct import reconstruct_frame


@functools.partial(jax.jit, static_argnums=0)
def _decode_scan(fmt: Format, seq, init_y, init_cb, init_cr):
    def step(carry, fr):
        y, cb, cr = carry
        # levels travel host->device at HALF width: int8 zigzag levels
        # (every transmittable AC/inter level is +/-127 by spec) plus a
        # uint8 intra-DC sidecar -- the decode-side mirror of the
        # encoder's levels8/dc_intra split (round-4 verdict item 3; the
        # levels tensor was the dominant decode H2D term).  Reassembly is
        # one fused add on device: slot 0 of an intra block is 0 in
        # levels8 and the sidecar is 0 everywhere else.
        levels = fr["levels8"].astype(jnp.int32)
        levels = levels.at[..., 0].add(fr["dc"].astype(jnp.int32))
        ny, ncb, ncr = reconstruct_frame(
            fmt, levels, fr["quant"], fr["intra"], fr["mv"],
            fr["fil"], y, cb, cr)
        return (ny, ncb, ncr), (ny, ncb, ncr)

    return jax.lax.scan(step, (init_y, init_cb, init_cr), seq)


def split_levels(levels: np.ndarray, intra_mb: np.ndarray):
    """(T, nMB, 6, 64) int16 levels -> (levels8 int8, dc uint8) halves.

    Host-side mirror of the C++ parser's direct int8 output, for the
    ParsedFrame paths.  intra_mb: (T, nMB) bool (intra & coded).

    The sidecar mask is intra_mb OR slot0 > 127: a resync parse can keep
    a PARTIALLY decoded intra MB whose DC (1..254) landed in slot 0 with
    coded=False (damage struck mid-MB), and 128..254 would wrap in the
    int8 cast -- a round-5 review repro showed the CLI decode path
    diverging from the native sidecar path by up to 59 gray levels on
    the same corrupted stream.  Any slot0 <= 127 is int8-safe wherever
    it rides (device reassembly just adds the two halves), so the
    value-based clause exactly covers the remaining wrap risk."""
    slot0 = levels[..., 0]
    to_dc = intra_mb[..., None] | (slot0 > 127)
    dc = np.where(to_dc, slot0, 0).astype(np.uint8)
    levels8 = levels.copy()
    levels8[..., 0] = np.where(to_dc, 0, slot0)
    return levels8.astype(np.int8), dc


def frames_to_tensors(frames: List[ParsedFrame]):
    """Stack parsed frames into (T, ...) device-ready arrays."""
    intra = np.stack([f.intra & f.coded for f in frames])
    levels8, dc = split_levels(np.stack([f.levels for f in frames]), intra)
    return dict(
        levels8=jnp.asarray(levels8),
        dc=jnp.asarray(dc),
        quant=jnp.asarray(np.stack([f.quant for f in frames]), jnp.int32),
        intra=jnp.asarray(intra),
        mv=jnp.asarray(np.stack([f.mv for f in frames]), jnp.int32),
        fil=jnp.asarray(np.stack([f.fil & f.coded for f in frames])),
    )


def decode_frames(frames: List[ParsedFrame], init=None):
    """Reconstruct planes for already-parsed frames (single format).

    Returns (y (T,H,W), cb, cr) uint8 arrays.
    """
    if not frames:
        raise ValueError("no frames")
    fmt = frames[0].fmt
    if any(f.fmt is not fmt for f in frames):
        raise ValueError("mixed picture formats in one sequence")
    seq = frames_to_tensors(frames)
    if init is None:
        init = (jnp.zeros((fmt.height, fmt.width), jnp.uint8),
                jnp.zeros((fmt.chroma_height, fmt.chroma_width), jnp.uint8),
                jnp.zeros((fmt.chroma_height, fmt.chroma_width), jnp.uint8))
    _, (y, cb, cr) = _decode_scan(fmt, seq, *init)
    return y, cb, cr


def decode_seq(fmt: Format, seq) -> Tuple[np.ndarray, np.ndarray,
                                          np.ndarray]:
    """Reconstruct planes from a parse_to_tensors seq dict (the hot
    batched path -- no per-frame objects).  Returns uint8 (T, ...) arrays.
    """
    init = (jnp.zeros((fmt.height, fmt.width), jnp.uint8),
            jnp.zeros((fmt.chroma_height, fmt.chroma_width), jnp.uint8),
            jnp.zeros((fmt.chroma_height, fmt.chroma_width), jnp.uint8))
    _, (y, cb, cr) = _decode_scan(
        fmt, {k: jnp.asarray(v) for k, v in seq.items()}, *init)
    return np.asarray(y), np.asarray(cb), np.asarray(cr)


@functools.partial(jax.jit, static_argnums=0)
def _decode_scan_batch(fmt: Format, seqs):
    """vmapped multi-stream reconstruct: seqs leaves are (S, T, ...)."""
    def one(seq):
        init = (jnp.zeros((fmt.height, fmt.width), jnp.uint8),
                jnp.zeros((fmt.chroma_height, fmt.chroma_width), jnp.uint8),
                jnp.zeros((fmt.chroma_height, fmt.chroma_width), jnp.uint8))
        _, planes = _decode_scan(fmt, seq, *init)
        return planes
    return jax.vmap(one)(seqs)


def decode_seq_batch(fmt: Format, seq_list):
    """Reconstruct MANY equal-length streams in one batched device
    dispatch (the multi-stream tool path: one vmapped scan instead of S
    sequential dispatches -- small CIF/QCIF frames underfill the chip one
    stream at a time, exactly like the encode side).

    seq_list: list of parse_to_tensors seq dicts, all same fmt and frame
    count.  Returns a list of (y, cb, cr) uint8 (T, ...) arrays.
    """
    batch = {k: jnp.stack([jnp.asarray(s[k]) for s in seq_list])
             for k in seq_list[0]}
    y, cb, cr = (np.asarray(p) for p in _decode_scan_batch(fmt, batch))
    return [(y[i], cb[i], cr[i]) for i in range(len(seq_list))]


def parse_any(data: bytes, resync: bool = False) -> List[ParsedFrame]:
    """Parse with the C++ engine when available (identical contract to the
    Python oracle -- tests/test_native.py), else pure Python.

    resync=True enables start-code error recovery: damaged GOBs keep
    their already-decoded MBs, the rest reconstruct as
    copy-from-reference (see parse_stream(strict=False))."""
    from ..native import load
    native = load()
    if native is not None:
        return native.parse(data, resync=resync)
    return parse_stream(data, strict=not resync)


def parse_to_tensors(data: bytes, resync: bool = False):
    """Parse one single-format stream straight to the stacked (T, ...)
    tensors `_decode_scan` consumes, skipping per-frame ParsedFrame
    objects (the hot batched-decode path; see binding.parse_tensors).

    Returns (fmt, tr (T,) np.ndarray, seq dict).  Falls back to the Python
    parser when the native engine is unavailable.
    """
    from ..entropy.parse import StreamError
    from ..native import load
    native = load()
    if native is not None:
        return native.parse_tensors(data, resync=resync)
    frames = parse_stream(data, strict=not resync)
    if not frames:
        raise StreamError("empty stream")
    fmt = frames[0].fmt
    if any(f.fmt is not fmt for f in frames):
        # same error contract as the native path
        raise StreamError("mixed picture formats in one sequence")
    # dtypes match binding.parse_tensors (levels8 int8 + dc uint8)
    intra = np.stack([f.intra & f.coded for f in frames])
    levels8, dc = split_levels(np.stack([f.levels for f in frames]), intra)
    seq = dict(
        levels8=levels8,
        dc=dc,
        quant=np.stack([f.quant for f in frames]).astype(np.int32),
        intra=intra,
        mv=np.stack([f.mv for f in frames]).astype(np.int32),
        fil=np.stack([f.fil & f.coded for f in frames]),
    )
    return fmt, np.asarray([f.tr for f in frames], np.int32), seq


def parse_many(datas: List[bytes]) -> List[List[ParsedFrame]]:
    """Parse multiple independent streams, fanning across a thread pool
    (see utils.fan_map -- the ctypes C++ parse releases the GIL), like
    encode finalize (distrib.mesh.serialize_streams)."""
    from ..utils import fan_map
    from ..native import load
    load()  # build/load once before fanning out
    return fan_map(parse_any, datas)


def decode_stream(data: bytes, resync: bool = False
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                             List[ParsedFrame]]:
    """bytes -> (y, cb, cr) uint8 arrays (T, ...) + the parsed symbol view."""
    frames = parse_any(data, resync=resync)
    y, cb, cr = decode_frames(frames)
    return np.asarray(y), np.asarray(cb), np.asarray(cr), frames
