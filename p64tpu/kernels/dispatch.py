"""The one place where the device platform picks a kernel formulation.

Only motion estimation's SAD map differs by platform: the GPU runs the
Pallas-Triton kernel (me_triton.sad_map_triton), the CPU the plain-XLA
shifted form (me.sad_map_shifted).  Both are bit-exact against the int64
oracle (`p64tpu.tools.parity` checks this on the card, the CPU tests on the
CPU), so the choice only changes speed; PERF.md records the measurements.
The choice is a plain function of the platform string, so the CPU tests
can check what the GPU gets.
"""

from __future__ import annotations

_SAD_BY_PLATFORM = {"gpu": "triton", "cpu": "shifted"}


def sad_formulation(platform: str) -> str:
    """SAD formulation for a JAX platform name ("gpu" or "cpu")."""
    try:
        return _SAD_BY_PLATFORM[platform]
    except KeyError:
        raise ValueError(
            f"no SAD formulation for platform {platform!r}; "
            f"known: {sorted(_SAD_BY_PLATFORM)}") from None


def current_sad_formulation() -> str:
    """SAD formulation for the default backend (read at trace time)."""
    import jax
    return sad_formulation(jax.default_backend())
