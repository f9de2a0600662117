"""2-D real FFT magnitude and log normalization.

reference: src/fft_processing.c
  * pgm_fft (:18-63): FFTW real-to-complex 2-D transform; stores
    |X|^2 = re^2 + im^2 over the half spectrum of width W//2+1.
  * pgm_normalize_fft (:173-213): global max, G_s = 1/(2*log(sqrt(max)+1)),
    then x < 1 -> 0 else log(x)*G_s (log-compressed to [0, 1]).

XLA's native FFT op via jnp.fft.rfft2 (complex64; cuFFT on the GPU).  The
input has its DC bias removed beforehand (reference src/blur_profile.c:233
subtracts the *RGB-brightness* mean, not the luma mean — see pipeline), which
keeps the spectrum's dynamic range well inside f32 after log compression.
"""

from __future__ import annotations

import jax.numpy as jnp


def magnitude_fft(pgm: jnp.ndarray) -> jnp.ndarray:
    """|rfft2(pgm)|^2, shape (H, W//2+1) float32."""
    spec = jnp.fft.rfft2(pgm)
    return jnp.square(jnp.real(spec)) + jnp.square(jnp.imag(spec))


def normalize_fft(mag_sq: jnp.ndarray, mx=None) -> jnp.ndarray:
    """Log compression with the reference's G_s gain (src/fft_processing.c:192-199).

    ``mx`` overrides the spectrum max for sharded callers that already
    hold the global max from a pmax (parallel/spatial._sharded_blur_bins)
    — keeping the G_s formula and the <1 gating in exactly one place."""
    if mx is None:
        mx = jnp.max(mag_sq)
    g_s = 1.0 / (2.0 * jnp.log(jnp.sqrt(mx) + 1.0))
    safe = jnp.where(mag_sq < 1.0, 1.0, mag_sq)
    return jnp.where(mag_sq < 1.0, 0.0, jnp.log(safe) * g_s)


def magnitude_fft_normalized(pgm_dc_removed: jnp.ndarray) -> jnp.ndarray:
    """compute_magnitude_fft equivalent (reference src/fft_processing.c:70-74)."""
    return normalize_fft(magnitude_fft(pgm_dc_removed))


def fft_shift(half_mag: jnp.ndarray) -> jnp.ndarray:
    """Center a half-spectrum magnitude for display: (H, W2) -> (H, 2*W2-1).

    Dev/viz counterpart of the reference's fft_shift
    (src/fft_processing.c:111-157): the right half is the input with rows
    rolled so DC lands on the center row, the left half is its 180-degree
    rotation (the magnitude of a real signal's spectrum is symmetric under
    point reflection about DC).  Documented deviation: the reference writes
    its output buffer with the *input* width as the row stride
    (``fft_image->data[y_val*fft_width + x_val]`` where ``fft_width`` is
    the input's width but the image is ``2*width-1`` wide), scrambling the
    result — undefined/buggy layout we do not reproduce.  For odd H and
    odd full width this matches ``np.fft.fftshift`` of the full spectrum
    exactly; for even sizes the left half is off by one row, exactly as a
    180-degree rotation implies.
    """
    h, w2 = half_mag.shape
    right = jnp.roll(half_mag, h // 2, axis=0)
    left = right[::-1, ::-1][:, :-1]
    return jnp.concatenate([left, right], axis=1)
