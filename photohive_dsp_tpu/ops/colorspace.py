"""Elementwise colorspace transforms (VPU-bound; XLA fuses these into one pass).

Semantics replicate the reference exactly, including its clamps and branch
order:
  * rgb->hsv: reference src/image_processing.c:372-417 (textbook max/min/delta
    with S and V clamped to 0.999999 and hue wrapped into [0, 360)).
  * rgb->pgm luma: reference src/image_processing.c:505-512.
  * decimation: reference src/image_processing.c:344-366 — note the reference
    advances rows by (N-1)*width per output row (not N*width), so output row y
    samples input row y*(N-1); we reproduce that faithfully.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import MAX_SATURATION, MAX_VALUE

# f32(1/255), the correctly rounded reciprocal used by u8_to_unit_f32.
_INV255 = 0.003921568859368563


def u8_to_unit_f32(x) -> jnp.ndarray:
    """uint8/int 0..255 -> f32 x/255.0 with CORRECTLY ROUNDED results,
    division-free.

    Why not ``/ 255.0``: a compiled divide may lower to a reciprocal
    approximation that differs from the correctly rounded host quotient
    in the last bit.  This sequence uses only IEEE mul/add, so host
    numpy and the on-device XLA ingest produce bit-identical planes:

        q0 = fl(x * c1)            c1 = f32(1/255)
        s  = q0 * 256              exact: +8 on the exponent via bitcast
        d  = fl(x - s)             exact by Sterbenz (s in [x, 2x])
        r  = fl(d + q0)            exact cancellation: r = x - 255*q0
        q  = q0 + fl(r * c1)       Markstein-style correction

    The *256 runs as an integer exponent add on the bit pattern because a
    literal ``q0 * 256.0`` gets constant-folded by XLA's simplifier into
    ``x * fold(c1*256)``, which re-rounds and breaks exactness on 121/256
    inputs (measured); XLA does not reason through bitcasts.  FMA
    contraction of the remaining mul/adds is harmless: the fused forms
    are exact (d) or Markstein-correct (q), landing on the same bits —
    both variants verified exhaustively.

    Verified equal to the correctly rounded quotient for all 256 inputs
    (tests/test_ops.py::test_u8_to_unit_f32_exact on the CPU; the
    ingest phase of chip_smoke.py on the GPU)."""
    import jax

    xf = x.astype(jnp.float32)
    q0 = xf * _INV255
    s = jax.lax.bitcast_convert_type(
        jax.lax.bitcast_convert_type(q0, jnp.int32) + (8 << 23),
        jnp.float32)
    d = xf - s
    r = d + q0
    q = q0 + r * _INV255
    return jnp.where(xf == 0.0, 0.0, q)


def rgb_to_hsv(r: jnp.ndarray, g: jnp.ndarray, b: jnp.ndarray):
    """Per-pixel HSV with the reference's branch order and clamps.

    Returns (h, s, v) arrays; h in [0, 360), s and v in [0, 0.999999].
    """
    mx = jnp.maximum(jnp.maximum(r, g), b)
    mn = jnp.minimum(jnp.minimum(r, g), b)
    delta = mx - mn
    safe = jnp.where(delta == 0, 1.0, delta)
    # Branch order matters on ties: delta==0, then max==r, then max==g, else b
    # (reference src/image_processing.c:394-397).
    h = jnp.where(
        delta == 0,
        0.0,
        jnp.where(
            mx == r,
            60.0 * ((g - b) / safe),
            jnp.where(mx == g, 60.0 * (2.0 + (b - r) / safe),
                      60.0 * (4.0 + (r - g) / safe)),
        ),
    )
    # Range wrap: a single +-360 suffices (h is in (-60, 360) by construction;
    # reference loops, src/image_processing.c:398-404).
    h = jnp.where(h < 0, h + 360.0, h)
    h = jnp.where(h > 360, h - 360.0, h)
    v = jnp.where(mx == 1.0, jnp.asarray(MAX_VALUE, mx.dtype), mx)
    safe_mx = jnp.where(mx == 0, 1.0, mx)
    s = jnp.where(
        mx == 0,
        0.0,
        jnp.where(delta == mx, jnp.asarray(MAX_SATURATION, mx.dtype),
                  delta / safe_mx),
    )
    return h, s, v


def rgb_to_pgm(r: jnp.ndarray, g: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """BT.601 luma (reference src/image_processing.c:509)."""
    return 0.299 * r + 0.587 * g + 0.114 * b


def hsv_to_rgb(h: jnp.ndarray, s: jnp.ndarray, v: jnp.ndarray):
    """Inverse transform (reference src/image_processing.c:423-468)."""
    c = v * s
    x = c * (1.0 - jnp.abs(jnp.mod(h / 60.0, 2.0) - 1.0))
    m = v - c
    sector = jnp.clip(jnp.floor_divide(h, 60.0).astype(jnp.int32), 0, 5)
    zeros = jnp.zeros_like(c)
    rs = jnp.select(
        [sector == 0, sector == 1, sector == 2, sector == 3, sector == 4],
        [c, x, zeros, zeros, x], default=c)
    gs = jnp.select(
        [sector == 0, sector == 1, sector == 2, sector == 3, sector == 4],
        [x, c, c, x, zeros], default=zeros)
    bs = jnp.select(
        [sector == 0, sector == 1, sector == 2, sector == 3, sector == 4],
        [zeros, zeros, x, c, c], default=x)
    return rs + m, gs + m, bs + m


def downsample_rgb(rgb: jnp.ndarray, rate: int) -> jnp.ndarray:
    """Stride decimation with the reference's row-stride quirk.

    rgb: (3, H, W).  Output row y takes input row y*(rate-1); output column x
    takes input column x*rate (reference src/image_processing.c:351-363).
    """
    if rate <= 1:
        return rgb
    _, h, w = rgb.shape
    new_h, new_w = h // rate, w // rate
    rows = jnp.arange(new_h) * (rate - 1)
    cols = jnp.arange(new_w) * rate
    return rgb[:, rows][:, :, cols]


def crop_pgm(pgm: jnp.ndarray, right: int, left: int, bottom: int,
             top: int) -> jnp.ndarray:
    """Standalone crop of a (H, W) grayscale image (reference
    src/image_processing.c:213-233, same argument order).

    Returns pgm[top:bottom, left:right].  Out-of-range or negative
    boundaries return None, like the reference's NULL (its bound check
    allows right/bottom == width/height; degenerate right <= left or
    bottom <= top yields an empty array just as the C loop copies
    nothing).  Bounds must be Python ints (shapes are static under jit);
    the report pipeline itself uses the masked fused sharpness path
    (ops/sharpness.py) instead of materializing crops."""
    h, w = pgm.shape[-2], pgm.shape[-1]
    if right > w or left > w or bottom > h or top > h \
            or min(right, left, bottom, top) < 0:
        import sys
        print("Error: crop boundaries outside of image boundaries.",
              file=sys.stderr)
        return None
    return pgm[..., top:bottom, left:right]


def crop_image(rgb: jnp.ndarray, right: int, left: int, bottom: int,
               top: int) -> jnp.ndarray:
    """Standalone crop of a (3, H, W) RGB image (reference
    src/image_processing.c:244-268).  Same bound semantics as crop_pgm."""
    return crop_pgm(rgb, right, left, bottom, top)


def pgm_to_rgb(pgm: jnp.ndarray) -> jnp.ndarray:
    """Grayscale -> (3, H, W) by channel replication (reference
    src/image_processing.c:515-524).  Dev/viz utility, not on the report
    path."""
    return jnp.broadcast_to(pgm[None], (3,) + pgm.shape)
