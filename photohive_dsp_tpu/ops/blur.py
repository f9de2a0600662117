"""Polar blur profile and directional blur-vector extraction.

reference: src/blur_profile.c
  * calculate_blur_profile (:34-126): per-FFT-pixel (angle, radius) binning
    with scatter accumulation, then per-bin mean.
  * vectorize_blur_profile (:324-416): per-angle low-band totals, trailing
    circular 5-tap smoothing, local-maxima streak detection, and conversion
    to <=10 (angle, magnitude) blur vectors.

Binning: the bin id of every FFT pixel depends only on the image
shape (see ops/geometry.py), so the scatter becomes a *static gather*: pixel
values are gathered into per-bin padded rows (zeros past each bin's count)
and tree-summed along the row — no scatter, no atomics, exact per-bin means.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import NUM_BLUR_VECTORS, ReportConfig
from .filtering import trailing_circular_box
from .geometry import polar_geometry


# Polar gather-table memory audit (defaults A=72, R=40; int32 entries).
# pad_index is (A*R, Lmax) where Lmax = the most populated bin, which grows
# linearly with the spectrum (the outermost radius ring dominates), so the
# table stays a constant ~3.6x the spectrum itself:
#
#   image        spectrum px   Lmax    table     spectrum   ratio
#   720x1080     0.39 M        451     5.2 MB    1.6 MB     3.3x
#   1080x1920    1.04 M        1293    14.9 MB   4.2 MB     3.6x
#   2160x3840    4.15 M        5171    59.6 MB   16.6 MB    3.6x
#   4320x7680    16.59 M       20662   238.0 MB  66.4 MB    3.6x
#
# Above the table budget (256 MB unless PHOTOHIVE_POLAR_TABLE_MB says
# otherwise) the table is dropped (pad_index=None) and the bins reduce
# through the flat bin-ids chunked one-hot contraction instead (O(1)
# extra memory beyond the P int32 ids — the reference's scatter,
# src/blur_profile.c:87-100, is O(1) too).  Below it the gather is the
# faster of the two.
def _pad_table_budget() -> int:
    import os

    env = os.environ.get("PHOTOHIVE_POLAR_TABLE_MB")
    return int(float(env) * 1e6) if env else 256_000_000


_FLAT_CHUNK = 1 << 16


class PolarTables(NamedTuple):
    """Device-resident polar binning constants (see geometry.PolarGeometry).

    ``pad_index`` is None for shapes whose gather table would exceed the
    budget (_pad_table_budget); the bins then reduce via flat bin ids."""

    pad_index: jnp.ndarray   # (A*R, Lmax) int32 (gather path) | None
    bin_counts: jnp.ndarray  # (A*R,) int32
    bin_ids: jnp.ndarray     # (H * fft_width,) int32 (flat path)

    @classmethod
    def for_shape(cls, height: int, width: int, cfg: ReportConfig,
                  max_table_bytes: int = None) -> "PolarTables":
        geom = polar_geometry(height, width, cfg.angle_partitions,
                              cfg.radius_partitions)
        budget = (max_table_bytes if max_table_bytes is not None
                  else _pad_table_budget())
        pad = None
        if geom.pad_index.size * 4 <= budget:
            pad = jnp.asarray(geom.pad_index)
        return cls(pad_index=pad,
                   bin_counts=jnp.asarray(geom.bin_counts),
                   bin_ids=jnp.asarray(geom.bin_ids))


def polar_bin_sums_flat_xla(flat_vals: jnp.ndarray, bin_ids: jnp.ndarray,
                            num_bins: int) -> jnp.ndarray:
    """Flat-ids bin sums without the padded gather table: (P,) f32 x (P,)
    int32 -> (num_bins,) f32 via a scan of chunked one-hot contractions.
    Sentinel ids >=
    num_bins match no one-hot row and drop out, so callers pad freely."""
    p = flat_vals.shape[0]
    pad = (-p) % _FLAT_CHUNK
    if pad:
        flat_vals = jnp.concatenate(
            [flat_vals, jnp.zeros((pad,), flat_vals.dtype)])
        bin_ids = jnp.concatenate(
            [bin_ids, jnp.full((pad,), num_bins, jnp.int32)])
    n_chunks = flat_vals.shape[0] // _FLAT_CHUNK
    iota = jnp.arange(num_bins, dtype=jnp.int32)

    def body(acc, chunk):
        vals, ids = chunk
        onehot = (ids[:, None] == iota[None, :]).astype(flat_vals.dtype)
        return acc + jnp.dot(onehot.T, vals[:, None],
                             preferred_element_type=jnp.float32,
                             precision=jax.lax.Precision.HIGHEST)[:, 0], None

    init = jnp.zeros((num_bins,), jnp.float32)
    sums, _ = jax.lax.scan(
        body, init, (flat_vals.reshape(n_chunks, _FLAT_CHUNK),
                     bin_ids.reshape(n_chunks, _FLAT_CHUNK)))
    return sums


def blur_profile_bins(mag_norm: jnp.ndarray, tables: PolarTables,
                      num_angle_bins: int, num_radius_bins: int)\
        -> jnp.ndarray:
    """Mean normalized FFT magnitude per (angle, radius) bin.

    mag_norm: (H, W//2+1) normalized magnitude.
    Returns (A, R) f32 bins; empty bins are 0 (reference
    src/blur_profile.c:106-116).
    """
    if tables.pad_index is None:               # large shape: flat-ids path
        sums = polar_bin_sums_flat_xla(
            mag_norm.reshape(-1), tables.bin_ids,
            num_angle_bins * num_radius_bins)
    else:
        flat = jnp.concatenate(
            [mag_norm.reshape(-1), jnp.zeros((1,), mag_norm.dtype)]
        )
        padded = flat[tables.pad_index]        # (A*R, Lmax), zeros past count
        sums = jnp.sum(padded, axis=1)
    counts = tables.bin_counts.astype(mag_norm.dtype)
    means = jnp.where(tables.bin_counts > 0, sums / jnp.maximum(counts, 1), 0.0)
    return means.reshape(num_angle_bins, num_radius_bins)


def blur_profile_bins_batched(mag_norm: jnp.ndarray, tables: PolarTables,
                              num_angle_bins: int, num_radius_bins: int)\
        -> jnp.ndarray:
    """Batched bin means: (B, H, W//2+1) -> (B, A, R), the vmapped
    static gather."""
    return jax.vmap(
        lambda m: blur_profile_bins(m, tables, num_angle_bins,
                                    num_radius_bins))(mag_norm)


def vectorize_blur_profile(bins: jnp.ndarray, cfg: ReportConfig):
    """Extract <=10 blur vectors (reference src/blur_profile.c:324-416).

    Returns (angles int32 (10,), magnitudes f32 (10,)).  Unused slots are
    zero, exactly like the reference's calloc'd 10-slot group (:297-302).
    """
    a = cfg.angle_partitions
    r = cfg.radius_partitions
    radius_cutoff = r // cfg.blur_cutoff_ratio_denom

    tot = jnp.sum(bins[:, :radius_cutoff], axis=1)          # (A,)
    avg = jnp.sum(tot) / a
    smooth = trailing_circular_box(tot, 5)

    # Local maxima with circular neighbors: the reference's boundary cases
    # (:360-379) coincide with roll-based neighbor comparisons.
    left = jnp.roll(smooth, 1)
    right = jnp.roll(smooth, -1)
    is_max = (smooth > left) & (smooth > right) \
        & (smooth > avg * cfg.fft_streak_thresh)

    # Everything below is computed for *every* angle (vectorized — no sorts
    # or data-dependent gathers), then the first 10 maxima in
    # ascending angle order are selected into the 10 output slots (the
    # reference appends i=0, interior ascending, then i=A-1 — ascending).
    rank = jnp.cumsum(is_max) - 1                           # slot per maxima
    keep = is_max & (rank < NUM_BLUR_VECTORS)

    # Re-index the angle (:387): cur[i] = bins[(i + A//2) % A] — a static
    # circular roll; vet against the global average (:392-400).
    cur = jnp.roll(bins, -(a // 2), axis=0)                 # (A, R)
    blur_avg = jnp.sum(cur[:, :radius_cutoff], axis=1)
    suppressed = blur_avg > avg

    # Magnitude: first radius bin below the magnitude threshold (:403-412).
    below = cur < cfg.magnitude_thresh                      # (A, R)
    first_below = jnp.where(jnp.any(below, axis=1),
                            jnp.argmax(below, axis=1), r)
    magnitude = first_below.astype(bins.dtype) / float(r)

    # Angle in degrees (:413).  The C expression
    # (int)(180 * ((float)idx / (float)A) - 90) rounds in float32 *without*
    # FMA contraction — e.g. idx=50, A=72 gives 34.99999 -> 34, not 35.  XLA
    # may fuse the multiply-subtract, so the table is precomputed on host
    # with C's exact rounding, indexed by the rolled angle per slot.
    angle_idx = (np.arange(a) + a // 2) % a
    table = np.trunc(
        np.float32(180) * (angle_idx.astype(np.float32) / np.float32(a))
        - np.float32(90)
    ).astype(np.int32)

    live = keep & ~suppressed
    angles_a = jnp.where(live, jnp.asarray(table), 0)       # (A,) int32
    mags_a = jnp.where(live, magnitude, 0.0)

    # Scatter the <=10 kept maxima into their slots with a (10, A) one-hot
    # selection (slot k <- the angle whose maxima-rank is k).
    sel = (rank[None, :] == jnp.arange(NUM_BLUR_VECTORS)[:, None]) \
        & keep[None, :]                                     # (10, A)
    angles = jnp.sum(jnp.where(sel, angles_a[None, :], 0), axis=1,
                     dtype=jnp.int32)
    mags = jnp.sum(jnp.where(sel, mags_a[None, :], 0.0), axis=1)
    return angles, mags
