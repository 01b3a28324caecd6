"""Test configuration: force JAX onto CPU with 8 virtual devices so the whole
suite (including multi-device sharding tests) runs without an accelerator,
per SURVEY section 4 (e).  jax.config is set as well as the environment, in
case jax was imported before this file.  What needs the card runs in
chip_smoke.py.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# Persistent compile cache: the pinned-golden test compiles a full CIF
# rate-controlled scan; cache hits make suite re-runs cheap.
from p64tpu.utils import enable_compile_cache  # noqa: E402

enable_compile_cache()


def pytest_sessionstart(session):
    assert jax.default_backend() == "cpu", (
        "tests must run on the CPU backend; got "
        f"{jax.default_backend()}")
    assert jax.device_count() == 8, jax.device_count()
