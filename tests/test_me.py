"""Motion-estimation formulations, the kernel dispatch point, the parity
gate's CPU-checkable parts and the GPU-only entry points' refusal on CPU.

The Triton SAD kernel runs here in Pallas interpret mode; chip_smoke.py
checks the compiled kernel on the card at CIF width."""

import functools
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from p64tpu.kernels import dispatch, me, me_triton
from p64tpu.tools import parity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FORMULATIONS = {
    "sad_map": me.sad_map,
    "shifted": me.sad_map_shifted,
    "triton_interpret": functools.partial(me_triton.sad_map_triton,
                                          interpret=True),
}


@pytest.mark.parametrize("h,w,s", [(48, 64, 4), (144, 176, 15)])
@pytest.mark.parametrize("content", ["random", "periodic", "near"])
@pytest.mark.parametrize("form", sorted(FORMULATIONS))
def test_sad_formulation_matches_int64_oracle(form, content, h, w, s):
    cur, ref = parity.sad_planes(h, w)[content]
    got = np.asarray(FORMULATIONS[form](jnp.asarray(cur), jnp.asarray(ref),
                                        s))
    np.testing.assert_array_equal(got, me.sad_map_np(cur, ref, s))


def test_full_search_tiebreaks_follow_scan_order():
    # a flat patch and a periodic texture: many offsets tie, and argmin must
    # keep the FIRST minimum in dy-major scan order
    h, w, s = 48, 64, 4
    rng = np.random.default_rng(5)
    base = rng.integers(0, 256, (h, w))
    base[16:32, 16:48] = 128
    base[:16] = ((np.arange(w) % 4) < 2) * 200
    cur, ref = base, np.roll(base, 2, axis=1)
    gold = me.sad_map_np(cur, ref, s)
    mv, best, sad0 = (np.asarray(x) for x in me.full_search(
        jnp.asarray(cur, jnp.int32), jnp.asarray(ref, jnp.int32), s))
    first = gold.argmin(axis=0)
    offs = me.offset_table(s)
    assert ((gold == gold.min(axis=0)).sum(axis=0) > 1).any()  # real ties
    np.testing.assert_array_equal(mv[:, 0], offs[first, 1])
    np.testing.assert_array_equal(mv[:, 1], offs[first, 0])
    np.testing.assert_array_equal(best, gold.min(axis=0))
    np.testing.assert_array_equal(sad0, gold[me.zero_offset_index(s)])


@pytest.mark.parametrize("form", ["shifted", "triton_interpret"])
def test_sad_vmap_matches_per_stream_loop(form):
    h, w, s = 48, 64, 3
    rng = np.random.default_rng(9)
    cur = rng.integers(0, 256, (3, h, w), np.uint8)
    ref = rng.integers(0, 256, (3, h, w), np.uint8)
    fn = functools.partial(FORMULATIONS[form], search=s)
    got = np.asarray(jax.vmap(fn)(jnp.asarray(cur), jnp.asarray(ref)))
    for i in range(3):
        np.testing.assert_array_equal(
            got[i], np.asarray(fn(jnp.asarray(cur[i]), jnp.asarray(ref[i]))))


@pytest.mark.parametrize("platform,sad", [("gpu", "triton"),
                                          ("cpu", "shifted")])
def test_dispatch_choice_per_platform(platform, sad):
    assert dispatch.sad_formulation(platform) == sad


def test_dispatch_refuses_unknown_platform():
    with pytest.raises(ValueError, match="rocm"):
        dispatch.sad_formulation("rocm")


def test_dispatch_current_is_cpu_here():
    assert dispatch.current_sad_formulation() == "shifted"


def test_compile_cache_dir_unset_uses_checkout():
    from p64tpu.utils import compile_cache_dir
    assert compile_cache_dir({}) == os.path.join(REPO, ".jax_cache")


def test_compile_cache_dir_set_leaves_it_to_jax():
    from p64tpu.utils import compile_cache_dir
    assert compile_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}) is None


def test_parity_dct_and_block_bits_on_cpu():
    assert parity.check_dct(512, log=lambda m: None)
    assert parity.check_block_bits(1024, log=lambda m: None)


def test_block_bits_oracle_counts_escapes_and_short_form():
    from p64tpu.spec import luts
    lv = np.zeros((3, 64), np.int64)
    lv[0, 0] = 1                     # inter first coefficient, short form
    lv[1, 5] = 40                    # escape after a run of 4 (intra)
    lv[2, 63] = -2                   # run of 63 -> escape
    intra = np.array([False, True, False])
    got = parity.block_bits_np(lv, intra)
    assert got[0] == luts.TC_LEN[0, 1] - luts.FIRST01_SAVING
    assert got[1] == 20 and got[2] == 20


def _run_cpu(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_refuses_cpu():
    r = _run_cpu(["chip_smoke.py"], REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_cpu(["chip_smoke.py"], tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_bench_refuses_cpu():
    r = _run_cpu(["bench.py"], REPO)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
