"""Global image statistics: per-channel brightness/contrast, mean saturation.

reference: src/image_processing.c:533-553 (brightness = per-channel mean,
contrast = per-channel stddev via the two-pass mean/variance reducers in
src/filtering.c:125-148).  XLA lowers jnp reductions to blocked tree
sums, which keeps f32 accumulation error far below a sequential sum's;
parity with the f64 reference is enforced by SNR tests.
"""

from __future__ import annotations

import jax.numpy as jnp


def mean_and_std(x: jnp.ndarray):
    """Two-pass mean/stddev exactly like the reference's reducers."""
    mean = jnp.mean(x)
    var = jnp.mean(jnp.square(x - mean))
    return mean, jnp.sqrt(var)


def rgb_statistics(r: jnp.ndarray, g: jnp.ndarray, b: jnp.ndarray):
    """Returns (6,) vector [Br, Bg, Bb, Cr, Cg, Cb].

    reference: src/image_processing.c:543-553.
    """
    br, cr = mean_and_std(r)
    bg, cg = mean_and_std(g)
    bb, cb = mean_and_std(b)
    return jnp.stack([br, bg, bb, cr, cg, cb])


def mean_saturation(s: jnp.ndarray) -> jnp.ndarray:
    """Average of the (clamped) saturation channel.

    reference: src/image_processing.c:533-540 — computed on the downsampled
    image's HSV representation.
    """
    return jnp.mean(s)
