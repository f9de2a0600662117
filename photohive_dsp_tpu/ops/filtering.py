"""Small FIR stencils.

* 3x3 Laplacian with zero-padded borders — reference src/filtering.c:40-50
  (kernel) and :81-107 (zero-padded correlation).  Implemented as shifted
  adds, which XLA fuses into a single VPU pass; no im2col / scatter.
* Trailing circular 1-D box smoother — reference src/filtering.c:12-24:
  result[i] = mean_{j=0..size-1} x[(i-j) mod n]  (a *trailing* window, not
  centered — faithfully reproduced).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def laplacian_3x3(x: jnp.ndarray) -> jnp.ndarray:
    """response = 8*x - sum of 8 zero-padded neighbors.

    Matches filter_image(initialize_3x3_laplacian(), ...) semantics
    (reference src/filtering.c:40-50, :81-107): out-of-image taps contribute
    zero.

    Separable formulation: one horizontal triple-sum (the only lane-shifted
    pass), then a vertical triple-sum of it, and 9x - box3x3 == 8x - the 8
    neighbors: three shifted reads instead of eight.  FP results differ
    from the shifted-adds form
    only by f32 reassociation (~1e-6 absolute) — both forms reassociate
    the C reference's row-major tap loop, and the golden tests bound the
    final sharpness at rtol 1e-5.
    """
    h = jnp.pad(x, ((0, 0), (1, 1)))
    t = h[:, :-2] + h[:, 1:-1] + h[:, 2:]
    v = jnp.pad(t, ((1, 1), (0, 0)))
    box = v[:-2, :] + v[1:-1, :] + v[2:, :]
    return 9.0 * x - box


def trailing_circular_box(x: jnp.ndarray, size: int) -> jnp.ndarray:
    """Circular trailing box mean (reference src/filtering.c:12-24)."""
    acc = x
    for j in range(1, size):
        acc = acc + jnp.roll(x, j)
    return acc / float(size)


# ---------------------------------------------------------------------------
# General FIR + the reference's unused alternates (src/filtering.c:58,110,186)
# — present for component parity; not on the report path there or here.

SHARPNESS_AVG_THRESHOLD = 0.2  # reference src/filtering.c:6


def filter_image(x: jnp.ndarray, taps) -> jnp.ndarray:
    """Zero-padded 2-D correlation with an arbitrary MxN tap matrix.

    General form of reference filter_image (src/filtering.c:81-107):
    out-of-image taps contribute zero, no kernel flip (correlation), no
    normalization.  Runs as one XLA convolution; the 3x3 Laplacian keeps its dedicated shifted-add form above.
    """
    taps = jnp.asarray(taps, x.dtype)
    fh, fw = taps.shape
    out = lax.conv_general_dilated(
        x[None, None], taps[None, None],
        window_strides=(1, 1),
        padding=[(fh // 2, (fh - 1) // 2), (fw // 2, (fw - 1) // 2)],
        dimension_numbers=("NCHW", "OIHW", "NCHW"))
    return out[0, 0]


def create_filtered_rgb(rgb: jnp.ndarray, taps) -> jnp.ndarray:
    """Per-channel FIR over a (3, H, W) image (reference src/filtering.c:110-117)."""
    return jnp.stack([filter_image(rgb[c], taps) for c in range(3)])


def sharpness_avg(response: jnp.ndarray) -> jnp.ndarray:
    """Mean of above-threshold response values (reference src/filtering.c:58-72).

    Like the reference, yields a non-finite value when no element exceeds
    the threshold (0/0).
    """
    mask = response > SHARPNESS_AVG_THRESHOLD
    total = jnp.sum(jnp.where(mask, response, 0.0))
    return total / jnp.sum(mask)


def average_sharpness(pgm: jnp.ndarray) -> jnp.ndarray:
    """get_average_sharpness equivalent (reference src/filtering.c:186-199):
    Laplacian response -> thresholded mean."""
    return sharpness_avg(laplacian_3x3(pgm))
