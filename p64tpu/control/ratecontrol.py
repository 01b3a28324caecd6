"""Buffer-feedback rate control (RM8-style virtual buffer).

Reference behavior (SURVEY section 3d: p64.c rate control; mwtell-delta bit
accounting; QDFact/QOffs-style quantizer law -- names and exact law
UNVERIFIED, mount empty this round).  OUR documented law, centralized here
for calibration:

  target  = bit_rate // frame_rate                  (bits per coded frame)
  qdfact  = max(1, target // 31)
  at each GOB start:   q = clip(buffer // qdfact + qoffs, 1, 31)
  after each GOB:      buffer += gob_bits (header included)
  after each frame:    buffer += picture_header_bits - target, clamped >= 0
  frame skip:          while buffer > skip_threshold * target, skip an input
                       frame (TR advances; buffer -= target, clamped >= 0)

Everything is integer arithmetic on device; the *exact* gob_bits come from
the device bit-length model (p64tpu.entropy.lengths), so rate control runs
inside `jit`/`lax.scan` with no host round trip (this codec's inversion of the
reference's stream-tell feedback).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from ..spec.constants import QUANT_MAX, QUANT_MIN


@dataclasses.dataclass(frozen=True)
class RateConfig:
    """Rate-control parameters.

    bit_rate <= 0 disables rate control (fixed quantizer mode, the
    reference's -q path); skip_threshold_x is the buffer-fullness multiple
    of `target` above which input frames are skipped.
    """

    bit_rate: int = 0
    frame_rate: int = 30
    qoffs: int = 1
    skip_threshold_x: int = 4
    fixed_quant: int = 8
    #: mid-GOB quantizer adaptation: split each GOB into this many segments
    #: (transmission order); each later segment re-evaluates the buffer law
    #: including the modeled bits of earlier segments, and a changed
    #: quantizer is signaled with MQUANT on the segment's first
    #: coefficient-bearing MB (H.261 section 4.2.3; our granularity choice,
    #: calibration-pending -- SURVEY section 3d "verify granularity").
    #: 1 = one quantizer per GOB (GQUANT only, the round-1 behavior).
    mquant_segments: int = 1
    #: quantizer the very first GOB should see (seeds the virtual buffer so
    #: the first intra frame is not coded at QUANT=1 and does not blow the
    #: budget; RM8-style warm start, calibration-pending)
    initial_quant: int = 8
    #: minimum-rate fill: when a coded frame leaves the virtual buffer in
    #: deficit (content cheaper than the per-frame budget), pad the frame
    #: with MBA stuffing codes (11 bits each, H.261 Table 1) until the
    #: buffer is non-negative.  H.261 encoders must be able to pad against
    #: buffer underflow (SURVEY section 2 huffman.c row); granularity
    #: (frame-end, 11-bit quantum) is ours, calibration-pending.
    min_rate_fill: bool = True

    def initial_buffer(self) -> int:
        if not self.enabled:
            return 0
        return max(0, (self.initial_quant - self.qoffs) * self.qdfact)

    @property
    def enabled(self) -> bool:
        return self.bit_rate > 0

    @property
    def target_bits_per_frame(self) -> int:
        return max(1, self.bit_rate // self.frame_rate)

    @property
    def qdfact(self) -> int:
        return max(1, self.target_bits_per_frame // 31)


def gob_quant(cfg: RateConfig, buffer_bits: jnp.ndarray) -> jnp.ndarray:
    """QUANT for the next GOB from current buffer fullness (int32)."""
    if not cfg.enabled:
        # clamp: GQUANT 0 is forbidden on the wire (own parser rejects it),
        # so a misconfigured fixed_quant must not produce an illegal stream.
        # + buffer*0 keeps the value data-dependent so its varying type
        # under shard_map matches the rate-controlled path (see
        # core.encoder._skip_picture for the same pattern)
        q = min(max(cfg.fixed_quant, QUANT_MIN), QUANT_MAX)
        return jnp.int32(q) + buffer_bits.astype(jnp.int32) * 0
    q = buffer_bits // jnp.int32(cfg.qdfact) + jnp.int32(cfg.qoffs)
    return jnp.clip(q, QUANT_MIN, QUANT_MAX).astype(jnp.int32)


#: bits per MBA stuffing code (H.261 Table 1: '00000001111')
STUFF_BITS = 11


def stuff_count(cfg: RateConfig, buffer_bits: jnp.ndarray,
                picture_header_bits: int) -> jnp.ndarray:
    """Number of MBA stuffing codes needed at the end of this coded frame
    so the post-drain buffer is non-negative (minimum-rate fill).

    buffer_bits: the virtual buffer *including* this frame's GOB bits but
    before the per-frame drain (same value drain_after_frame receives).
    Returns an int32 scalar >= 0; always 0 when fill is disabled.
    """
    if not (cfg.enabled and cfg.min_rate_fill):
        # data-dependent zero: varying-type parity under shard_map (see
        # gob_quant for the same pattern)
        return buffer_bits.astype(jnp.int32) * 0
    b = (buffer_bits + jnp.int32(picture_header_bits)
         - jnp.int32(cfg.target_bits_per_frame))
    deficit = jnp.maximum(-b, 0)
    return ((deficit + STUFF_BITS - 1) // STUFF_BITS).astype(jnp.int32)


def drain_after_frame(cfg: RateConfig, buffer_bits: jnp.ndarray,
                      picture_header_bits: int) -> jnp.ndarray:
    """Apply the per-frame drain (call after all GOB bits were added)."""
    b = buffer_bits + jnp.int32(picture_header_bits) - jnp.int32(
        cfg.target_bits_per_frame)
    return jnp.maximum(b, 0).astype(jnp.int32)


def should_skip(cfg: RateConfig, buffer_bits: jnp.ndarray) -> jnp.ndarray:
    """True when the encoder should skip the next input frame."""
    if not cfg.enabled:
        return jnp.asarray(False)
    thr = jnp.int32(cfg.skip_threshold_x * cfg.target_bits_per_frame)
    return buffer_bits > thr


def drain_skipped(cfg: RateConfig, buffer_bits: jnp.ndarray) -> jnp.ndarray:
    b = buffer_bits - jnp.int32(cfg.target_bits_per_frame)
    return jnp.maximum(b, 0).astype(jnp.int32)
