"""Device parity gate: every formulation the device runs is bit-exact.

Each check compares what the default backend computes with an int64 numpy
oracle, with tolerance 0 (every result is an integer):

  sad    every in-tree SAD formulation that runs on this platform, on
         random, periodic near-tie and near-identical planes, plus
         full_search's motion vectors under the scan-order tie-break
  dct    fdct8x8, fdct8x8_zz and idct8x8 on random blocks
  bits   entropy.lengths.block_bits against a numpy gather of luts.TC_LEN
  pins   the pinned streams re-encoded here equal tests/pinned_goldens.json
         byte for byte (the CPU tests hold the CPU to the same pins, so
         this proves device == CPU bitstreams)

bench.py runs the gate in-process before it measures; chip_smoke.py runs
its checks as phases.

  python -m p64tpu.tools.parity     # exit status 0 = every check passed
"""

from __future__ import annotations

import json
import sys
import time
from typing import Callable, Dict

import numpy as np

Log = Callable[[str], None]


def _stderr(msg: str) -> None:
    print(f"[parity] {msg}", file=sys.stderr, flush=True)


def sad_planes(h: int, w: int, seed: int = 7) -> Dict[str, tuple]:
    """(cur, ref) uint8 plane pairs: random, periodic near-tie (a texture
    shifted by half its period, so many offsets tie) and near-identical
    (small residuals around a flat patch)."""
    rng = np.random.default_rng(seed)
    xx = np.mgrid[0:h, 0:w][1]
    per = (((xx % 8) < 4) * 200 + 20).astype(np.uint8)
    base = rng.integers(0, 256, (h, w))
    base[h // 4:h // 2, w // 4:w // 2] = 77
    near = np.clip(base + rng.integers(-2, 3, (h, w)), 0, 255)
    return {
        "random": (rng.integers(0, 256, (h, w), np.uint8),
                   rng.integers(0, 256, (h, w), np.uint8)),
        "periodic": (per, np.roll(per, 4, axis=1)),
        "near": (base.astype(np.uint8), near.astype(np.uint8)),
    }


def sad_formulations(platform: str) -> Dict[str, Callable]:
    """Every in-tree SAD formulation that runs on `platform`."""
    from ..kernels import me
    forms = {"sad_map": me.sad_map, "shifted": me.sad_map_shifted}
    if platform == "gpu":
        from ..kernels.me_triton import sad_map_triton
        forms["triton"] = sad_map_triton
    return forms


def check_sad(h: int = 288, w: int = 352, search: int = 15,
              log: Log = _stderr) -> bool:
    import jax
    import jax.numpy as jnp

    from ..kernels import me

    ok = True
    forms = sad_formulations(jax.default_backend())
    jitted = {k: jax.jit(f, static_argnums=2) for k, f in forms.items()}
    fs = jax.jit(me.full_search, static_argnums=2)
    offs = me.offset_table(search)
    for pname, (cur, ref) in sad_planes(h, w).items():
        gold = me.sad_map_np(cur, ref, search)
        cj, rj = jnp.asarray(cur), jnp.asarray(ref)
        for vname, f in jitted.items():
            bad = int((np.asarray(f(cj, rj, search)) != gold).sum())
            log(f"sad {vname}/{pname} {h}x{w} search {search}: "
                f"{bad} wrong entries")
            ok &= bad == 0
        mv, best, sad0 = (np.asarray(x) for x in
                          fs(cj.astype(jnp.int32), rj, search))
        bi = gold.argmin(axis=0)           # numpy keeps the FIRST minimum
        want_mv = np.stack([offs[bi][:, 1], offs[bi][:, 0]], axis=-1)
        bad = (int((mv != want_mv).any(axis=-1).sum())
               + int((best != gold.min(axis=0)).sum())
               + int((sad0 != gold[me.zero_offset_index(search)]).sum()))
        log(f"full_search/{pname}: {bad} wrong MVs or SADs")
        ok &= bad == 0
    return ok


def dct_oracles(x: np.ndarray, c: np.ndarray):
    """int64 re-computation of the documented DCT definitions:
    (fdct of x as (n, 8, 8), fdct in zigzag order (n, 64), idct of c)."""
    from ..kernels import dct
    from ..spec.zigzag import ZIGZAG
    mi = dct.MI.astype(np.int64)
    s = np.einsum("nx,ux->nu", x.reshape(-1, 64).astype(np.int64),
                  dct.MI2.astype(np.int64))
    f = (s + (1 << (dct.FWD_SCALE_BITS - 1))) >> dct.FWD_SCALE_BITS
    t = (np.einsum("ux,nuv->nxv", mi, c.astype(np.int64))
         + (1 << (dct.INV_SHIFT1 - 1))) >> dct.INV_SHIFT1
    i = (np.einsum("nxv,vy->nxy", t, mi)
         + (1 << (dct.INV_SHIFT2 - 1))) >> dct.INV_SHIFT2
    return f.reshape(-1, 8, 8), f[:, np.asarray(ZIGZAG)], i


def check_dct(n_blocks: int = 4096, log: Log = _stderr) -> bool:
    import jax
    import jax.numpy as jnp

    from ..kernels import dct

    rng = np.random.default_rng(11)
    x = rng.integers(-255, 256, (n_blocks, 8, 8)).astype(np.int32)
    c = rng.integers(-2048, 2048, (n_blocks, 8, 8)).astype(np.int32)
    want_f, want_zz, want_i = dct_oracles(x, c)
    ok = True
    for name, fn, arg, want in (("fdct8x8", dct.fdct8x8, x, want_f),
                                ("fdct8x8_zz", dct.fdct8x8_zz, x, want_zz),
                                ("idct8x8", dct.idct8x8, c, want_i)):
        got = np.asarray(jax.jit(fn)(jnp.asarray(arg)))
        bad = int((got != want).sum())
        log(f"{name} on {n_blocks} blocks: {bad} wrong entries")
        ok &= bad == 0
    return ok


def block_bits_np(levels: np.ndarray, intra: np.ndarray) -> np.ndarray:
    """numpy oracle of lengths.block_bits: a direct gather of TC_LEN."""
    from ..spec import luts
    lv = levels.astype(np.int64)
    p = np.arange(64)
    start = np.where(intra, 1, 0)[:, None]
    nz = (lv != 0) & (p >= start)
    inc = np.maximum.accumulate(np.where(nz, p, -1), axis=1)
    prev = np.maximum(np.concatenate(
        [np.full((len(lv), 1), -1), inc[:, :-1]], axis=1), start - 1)
    alev = np.minimum(np.abs(lv), luts.TC_LEN.shape[1] - 1)
    clen = luts.TC_LEN[p - prev - 1, alev]
    first01 = ~intra & (np.abs(lv[:, 0]) == 1)
    return (np.where(nz, clen, 0).sum(axis=1)
            - np.where(first01, luts.FIRST01_SAVING, 0))


def check_block_bits(n_blocks: int = 4096, log: Log = _stderr) -> bool:
    import jax
    import jax.numpy as jnp

    from ..entropy.lengths import block_bits

    rng = np.random.default_rng(13)
    # sparse levels: mostly zeros and small magnitudes (table codes), some
    # escapes (|level| > 15 or long runs); the first rows are all-zero and
    # single-coefficient blocks
    mag = np.where(rng.random((n_blocks, 64)) < 0.9,
                   rng.integers(1, 4, (n_blocks, 64)),
                   rng.integers(1, 128, (n_blocks, 64)))
    keep = rng.random((n_blocks, 64)) < rng.random((n_blocks, 1)) * 0.6
    lv = np.where(keep, mag * rng.choice([-1, 1], (n_blocks, 64)), 0)
    lv[0] = 0
    lv[1:64] = 0
    lv[np.arange(1, 64), np.arange(1, 64)] = 1
    intra = rng.random(n_blocks) < 0.5
    want = block_bits_np(lv, intra)
    got = np.asarray(jax.jit(block_bits)(jnp.asarray(lv, jnp.int32),
                                         jnp.asarray(intra)))
    bad = int((got != want).sum())
    log(f"block_bits on {n_blocks} blocks: {bad} wrong")
    return bad == 0


def check_pins(log: Log = _stderr) -> bool:
    from . import pinned
    with open(pinned.PIN_FILE) as f:
        want = json.load(f)
    t0 = time.time()
    got = pinned.current_hashes()
    bad = sorted(k for k in want if got.get(k) != want[k])
    log(f"pinned streams: {len(want) - len(bad)}/{len(want)} byte-identical "
        f"to the pins ({time.time() - t0:.1f}s){' FAIL ' + str(bad) if bad else ''}")
    return not bad and len(got) == len(want)


def run_all(log: Log = _stderr) -> bool:
    import jax
    d = jax.devices()[0]
    log(f"backend {d.platform} ({d.device_kind}), {jax.device_count()} "
        f"device(s)")
    ok = check_sad(log=log)
    ok &= check_dct(log=log)
    ok &= check_block_bits(log=log)
    ok &= check_pins(log=log)
    log("PARITY PASS" if ok else "PARITY FAIL")
    return ok


if __name__ == "__main__":
    sys.exit(0 if run_all() else 1)
