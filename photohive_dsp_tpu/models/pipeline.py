"""The single-image full-report pipeline — the framework's flagship "model".

Mirrors the reference orchestrator get_full_report_data
(src/interface.c:20-94) stage for stage, but as one pure jit-compiled
function over fixed shapes:

  downsample -> rgb2hsv (downsampled) -> rgb2pgm (full res)
  -> rgb statistics (full res) -> mean saturation -> color palette
  -> crop sharpness (pre-DC-removal pgm) -> DC removal with the RGB
     brightness mean -> magnitude FFT + log normalize -> polar bins
  -> blur vectors.

Behavioral subtleties honored (see SURVEY.md §3.1):
  * palette + saturation run on the *downsampled* image; stats, sharpness and
    blur profile run on the full-resolution original (src/interface.c:40-55);
  * sharpness is computed before DC removal (src/interface.c:73 vs :79);
  * the DC bias removed is (Br+Bg+Bb)/3, not the luma mean
    (src/interface.c:78).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..config import MAX_CROP_BOXES, ReportConfig
from ..ops.blur import PolarTables, blur_profile_bins, vectorize_blur_profile
from ..ops.colorspace import downsample_rgb, rgb_to_hsv, rgb_to_pgm
from ..ops.fft import magnitude_fft_normalized
from ..ops.quantize import OctreeTables, PaletteResult, color_palette
from ..ops.sharpness import variance_sharpness, variance_sharpness_batched
from ..ops.stats import mean_saturation, rgb_statistics


class ReportData(NamedTuple):
    """Fixed-shape device report: one image's full PhotoHive report."""

    rgb_stats: jnp.ndarray           # (6,) [Br, Bg, Bb, Cr, Cg, Cb]
    average_saturation: jnp.ndarray  # ()
    palette_hsv: jnp.ndarray         # (C, 3) valid-order HSV averages
    palette_pct: jnp.ndarray         # (C,)
    palette_n: jnp.ndarray           # () int32
    palette_ids: jnp.ndarray         # (C,) int32 backing cell ids (-1 pad)
    sharpness: jnp.ndarray           # (MAX_CROP_BOXES,)
    blur_bins: jnp.ndarray           # (A, R)
    blur_vector_angles: jnp.ndarray  # (NUM_BLUR_VECTORS,) int32 degrees
    blur_vector_mags: jnp.ndarray    # (NUM_BLUR_VECTORS,)


class ReportTables(NamedTuple):
    """All shape/config-static device constants for one image shape."""

    polar: PolarTables
    octree: OctreeTables

    @classmethod
    def build(cls, height: int, width: int,
              cfg: ReportConfig) -> "ReportTables":
        return cls(polar=PolarTables.for_shape(height, width, cfg),
                   octree=OctreeTables.for_config(cfg))


def full_report(rgb: jnp.ndarray, boxes: jnp.ndarray,
                boxes_valid: jnp.ndarray, tables: ReportTables,
                cfg: ReportConfig) -> ReportData:
    """Compute the full report for one image.

    rgb:         (3, H, W) float32 in [0, 1].
    boxes:       (MAX_CROP_BOXES, 4) int32 [top, bottom, left, right).
    boxes_valid: (MAX_CROP_BOXES,) bool.
    """
    down = downsample_rgb(rgb, cfg.downsample_rate)
    h, s, v = rgb_to_hsv(down[0], down[1], down[2])
    pgm = rgb_to_pgm(rgb[0], rgb[1], rgb[2])

    stats = rgb_statistics(rgb[0], rgb[1], rgb[2])
    s_bar = mean_saturation(s)
    palette = color_palette(h, s, v, cfg, tables.octree)
    sharp = variance_sharpness(pgm, boxes, boxes_valid)

    dc = (stats[0] + stats[1] + stats[2]) / 3.0
    mag = magnitude_fft_normalized(pgm - dc)
    bins = blur_profile_bins(mag, tables.polar, cfg.angle_partitions,
                             cfg.radius_partitions)
    angles, mags = vectorize_blur_profile(bins, cfg)

    return ReportData(
        rgb_stats=stats,
        average_saturation=s_bar,
        palette_hsv=palette.hsv,
        palette_pct=palette.percentages,
        palette_n=palette.n_valid,
        palette_ids=palette.parent_ids,
        sharpness=sharp,
        blur_bins=bins,
        blur_vector_angles=angles,
        blur_vector_mags=mags,
    )


def full_report_batched(rgb: jnp.ndarray, boxes: jnp.ndarray,
                        boxes_valid: jnp.ndarray, tables: ReportTables,
                        cfg: ReportConfig) -> ReportData:
    """Batched report: (B, 3, H, W) -> ReportData with leading batch dim.

    The throughput path: elementwise/FFT/stencil stages are vmapped; the
    histogram-shaped stages (cell counts, saliency sort, palette pixel
    pass) run batched so that the palette tier switch takes one scalar
    predicate for the whole batch.
    """
    from ..ops.blur import blur_profile_bins_batched
    from ..ops.quantize import color_palette_batched

    down = jax.vmap(lambda x: downsample_rgb(x, cfg.downsample_rate))(rgb)
    pgm = jax.vmap(lambda x: rgb_to_pgm(x[0], x[1], x[2]))(rgb)

    stats = jax.vmap(lambda x: rgb_statistics(x[0], x[1], x[2]))(rgb)
    h, s, v = jax.vmap(lambda x: rgb_to_hsv(x[0], x[1], x[2]))(down)
    s_bar = jax.vmap(mean_saturation)(s)
    palette = color_palette_batched(h, s, v, cfg, tables.octree)
    sharp = variance_sharpness_batched(pgm, boxes, boxes_valid)

    dc = (stats[:, 0] + stats[:, 1] + stats[:, 2]) / 3.0
    mag = jax.vmap(magnitude_fft_normalized)(pgm - dc[:, None, None])
    bins = blur_profile_bins_batched(mag, tables.polar, cfg.angle_partitions,
                                     cfg.radius_partitions)
    angles, mags = jax.vmap(
        lambda bb: vectorize_blur_profile(bb, cfg))(bins)

    return ReportData(
        rgb_stats=stats, average_saturation=s_bar,
        palette_hsv=palette.hsv, palette_pct=palette.percentages,
        palette_n=palette.n_valid, palette_ids=palette.parent_ids,
        sharpness=sharp, blur_bins=bins,
        blur_vector_angles=angles, blur_vector_mags=mags,
    )


@functools.lru_cache(maxsize=16)
def jitted_full_report(height: int, width: int, cfg: ReportConfig):
    """Compiled report fn + its tables for a given image shape and config."""
    tables = ReportTables.build(height, width, cfg)
    fn = jax.jit(functools.partial(full_report, cfg=cfg))
    return fn, tables


def empty_boxes() -> Tuple[jnp.ndarray, jnp.ndarray]:
    boxes = jnp.zeros((MAX_CROP_BOXES, 4), jnp.int32)
    valid = jnp.zeros((MAX_CROP_BOXES,), bool)
    return boxes, valid
