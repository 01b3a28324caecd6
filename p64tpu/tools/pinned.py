"""Pinned own-output bitstream goldens (VERDICT round-2 item 3).

Why: encoder and decoder move together, so every roundtrip test keeps
passing even when a perf refactor silently changes encoder *decisions*
(thresholds, tie-breaks, rate law).  Pinning the sha256 of the encoded
streams for fixed content + fixed settings makes any bitstream drift loud
and deliberate: a change that touches decisions must regenerate the pins in
the same commit (``python -m p64tpu.tools.pinned --write``) and say why.

Covers SURVEY section 4 (b-c) until the reference mount materializes: the
three golden_content BASELINE configs plus the four adversarial
sequences at fixed-quant and rate-controlled settings.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
from typing import Dict, Iterator, Tuple

PIN_FILE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "tests", "pinned_goldens.json")


def pinned_streams() -> Iterator[Tuple[str, bytes]]:
    """Yield (name, encoded_bytes) for every pinned configuration.

    Content and settings are frozen; config3 runs 10 of its 30 frames to
    bound CPU compile time (the full config is make_goldens territory).
    """
    import jax.numpy as jnp

    from ..control.ratecontrol import RateConfig
    from ..core import encoder
    from ..spec.constants import CIF, QCIF
    from . import golden_content as gc

    def enc(fmt, frames_np, **cfg_kw):
        frames = {k: jnp.asarray(v) for k, v in frames_np.items()}
        cfg = encoder.EncoderConfig(fmt=fmt, **cfg_kw)
        data, _, _ = encoder.encode_to_bytes(cfg, frames)
        return data

    yield "config1_qcif_intra_q12", enc(
        QCIF, gc.config1_qcif_intra(),
        rate=RateConfig(fixed_quant=12), intra_only=True)
    yield "config2_qcif_inter_q12_s15", enc(
        QCIF, gc.config2_qcif_inter(), search=15,
        rate=RateConfig(fixed_quant=12))
    yield "config3_cif_rc768k_t10", enc(
        CIF, gc.config3_cif_rc(10),
        search=15, rate=RateConfig(bit_rate=768000))
    for name, y in sorted(gc.adversarial_sequences().items()):
        frames_np = gc.luma_to_frames(y)
        yield f"adv_{name}_q10", enc(
            QCIF, frames_np, rate=RateConfig(fixed_quant=10))
        yield f"adv_{name}_rc192k", enc(
            QCIF, frames_np,
            rate=RateConfig(bit_rate=192_000, frame_rate=30))
    # mid-GOB MQUANT coverage (round-4): locks the segment-quantizer
    # choice incl. the second-pass cost model, which no other pin reaches
    yield "cif_rc1M_mquant3_t3", enc(
        CIF, {k: v[:3] for k, v in gc.config3_cif_rc(3).items()},
        search=15,
        rate=RateConfig(bit_rate=1_024_000, frame_rate=30,
                        mquant_segments=3))
    yield "mquant2pass_graded_qcif", enc(
        QCIF, gc.graded_energy_qcif(),
        rate=RateConfig(bit_rate=700_000, frame_rate=30,
                        mquant_segments=3))


def current_hashes() -> Dict[str, Dict[str, object]]:
    out = {}
    for name, data in pinned_streams():
        out[name] = dict(sha256=hashlib.sha256(data).hexdigest(),
                         bytes=len(data))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--write", action="store_true",
                    help=f"regenerate {PIN_FILE}")
    args = ap.parse_args()
    got = current_hashes()
    if args.write:
        with open(PIN_FILE, "w") as f:
            json.dump(got, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"wrote {len(got)} pins -> {PIN_FILE}")
        return 0
    with open(PIN_FILE) as f:
        want = json.load(f)
    bad = [k for k in want if got.get(k) != want[k]]
    missing = [k for k in got if k not in want]
    for k in bad:
        print(f"DRIFT {k}: pinned {want[k]} != current {got.get(k)}")
    for k in missing:
        print(f"UNPINNED {k}: {got[k]}")
    print("PINS OK" if not (bad or missing) else "PINS CHANGED")
    return 0 if not (bad or missing) else 1


if __name__ == "__main__":
    sys.exit(main())
