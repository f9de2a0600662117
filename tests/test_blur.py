"""Parity tests for the FFT, polar blur profile, and blur-vector extraction."""

import numpy as np
import pytest

import jax.numpy as jnp

from photohive_dsp_tpu.config import ReportConfig
from photohive_dsp_tpu.ops import blur, fft, geometry
from . import golden_ref as gold
from .util import snr_db, structured_image, directional_blur_image

CFG = ReportConfig()


def test_newton_int_sqrt_matches_scalar():
    vals = np.concatenate([
        np.array([0.0, 1.0, 2.0, 3.9, 4.0, 1599.9, 1600.0, 1600.1]),
        np.random.default_rng(0).uniform(0, 1e7, 500),
    ])
    vec = geometry.newton_int_sqrt(vals)
    ref = np.array([gold.newton_int_sqrt(v) for v in vals])
    np.testing.assert_array_equal(vec, ref)


def test_polar_map_matches_golden():
    for (h, w) in [(480, 640), (479, 641), (350, 350)]:
        geom = geometry.polar_geometry(h, w, CFG.angle_partitions,
                                       CFG.radius_partitions)
        r_sq, phi = gold.polar_map(h, w)
        a, r = CFG.angle_partitions, CFG.radius_partitions
        phi_bin = ((phi + gold.REFERENCE_PI * 0.5) / gold.REFERENCE_PI
                   * (a - 1)).astype(np.int64)
        fft_w = w // 2 + 1
        rbss = (fft_w * fft_w + (h * h) // 4) // (r * r)
        ref_rb = np.array([gold.newton_int_sqrt(x)
                           for x in (r_sq.ravel() / rbss)])
        ref_rb = np.where(ref_rb == r, r - 1, ref_rb)
        ref_bins = np.clip(phi_bin.ravel(), 0, a - 1) * r \
            + np.clip(ref_rb, 0, r - 1)
        np.testing.assert_array_equal(geom.bin_ids, ref_bins)
        # counts conserve all pixels
        assert geom.bin_counts.sum() == h * fft_w


@pytest.mark.parametrize("shape", [(480, 640), (351, 467)])
def test_fft_and_bins_parity(shape):
    h, w = shape
    img = structured_image(h, w)
    pgm = gold.rgb2pgm(*img)
    dc = (img[0].mean() + img[1].mean() + img[2].mean()) / 3.0
    golden_mag = gold.normalize_fft(gold.magnitude_fft(pgm - dc))
    golden_bins = gold.blur_profile_from_shape(
        golden_mag, h, w, CFG.radius_partitions, CFG.angle_partitions)

    mag = fft.magnitude_fft_normalized(jnp.asarray(pgm - dc, jnp.float32))
    assert snr_db(golden_mag, np.asarray(mag)) > 40
    tables = blur.PolarTables.for_shape(h, w, CFG)
    bins = blur.blur_profile_bins(mag, tables, CFG.angle_partitions,
                                  CFG.radius_partitions)
    assert snr_db(golden_bins, np.asarray(bins)) > 40


def test_vectorize_parity_synthetic():
    # Synthetic profile with two clear streaks; run both implementations.
    rng = np.random.default_rng(3)
    a, r = CFG.angle_partitions, CFG.radius_partitions
    bins = rng.uniform(0.05, 0.12, (a, r))
    for angle, height in [(10, 0.9), (40, 0.7)]:
        bins[angle, :] = np.linspace(height, 0.0, r)
    ref = gold.vectorize_blur_profile(bins, CFG.fft_streak_thresh,
                                      CFG.magnitude_thresh,
                                      CFG.blur_cutoff_ratio_denom)
    angles, mags = blur.vectorize_blur_profile(
        jnp.asarray(bins, jnp.float32), CFG)
    ours = list(zip(np.asarray(angles).tolist(),
                    np.asarray(mags).tolist()))
    for (ra, rm), (oa, om) in zip(ref, ours):
        assert ra == oa
        assert abs(rm - om) < 1e-6


def test_vectorize_detects_motion_blur():
    # Anisotropic spectrum -> directional FFT streak -> reported blur vector.
    img = directional_blur_image(480, 640)
    pgm = gold.rgb2pgm(*img)
    dc = pgm.mean()
    mag = fft.magnitude_fft_normalized(jnp.asarray(pgm - dc, jnp.float32))
    tables = blur.PolarTables.for_shape(480, 640, CFG)
    bins = blur.blur_profile_bins(mag, tables, CFG.angle_partitions,
                                  CFG.radius_partitions)
    angles, mags = blur.vectorize_blur_profile(bins, CFG)
    golden_mag = gold.normalize_fft(gold.magnitude_fft(pgm - dc))
    golden_bins = gold.blur_profile_from_shape(golden_mag, 480, 640,
                                               CFG.radius_partitions,
                                               CFG.angle_partitions)
    ref = gold.vectorize_blur_profile(golden_bins, CFG.fft_streak_thresh,
                                      CFG.magnitude_thresh,
                                      CFG.blur_cutoff_ratio_denom)
    ours = list(zip(np.asarray(angles).tolist(), np.asarray(mags).tolist()))
    assert any(m > 0 for _, m in ours)  # a streak is detected
    for (ra, rm), (oa, om) in zip(ref, ours):
        assert ra == oa
        assert abs(rm - om) < 1e-5


def test_polar_flat_xla_matches_gather():
    """The flat-ids chunked one-hot reduction (large-shape route) must
    match the padded-gather path to float32 rounding, and the memory
    routing must drop the gather table above the budget."""
    h, w = 480, 640
    geom = geometry.polar_geometry(h, w, CFG.angle_partitions,
                                   CFG.radius_partitions)
    num_bins = CFG.angle_partitions * CFG.radius_partitions
    rng = np.random.default_rng(3)
    mag = jnp.asarray(rng.random((h, geom.fft_width)), jnp.float32)
    tables = blur.PolarTables.for_shape(h, w, CFG)
    assert tables.pad_index is not None  # small shape keeps the table
    ref = np.asarray(blur.blur_profile_bins(
        mag, tables, CFG.angle_partitions, CFG.radius_partitions))
    flat_sums = np.asarray(blur.polar_bin_sums_flat_xla(
        mag.reshape(-1), tables.bin_ids, num_bins))
    counts = np.asarray(tables.bin_counts)
    flat_means = np.where(counts > 0, flat_sums / np.maximum(counts, 1), 0.0)
    flat_means = flat_means.reshape(ref.shape)
    assert np.abs(flat_means - ref).max() < 1e-5
    # routed tables: pad_index dropped, pipeline output identical
    routed = blur.PolarTables(pad_index=None,
                              bin_counts=tables.bin_counts,
                              bin_ids=tables.bin_ids)
    got = np.asarray(blur.blur_profile_bins(
        mag, routed, CFG.angle_partitions, CFG.radius_partitions))
    assert np.abs(got - ref).max() < 1e-5


def test_polar_table_memory_routing():
    """Shapes whose gather table exceeds the budget take the flat route on
    both the single-chip and sharded tables (the gather table is ~3.6x the
    spectrum, 238 MB at 8K).  A 24 MB budget is passed explicitly: it
    puts 4K over the line and 1080p under it."""
    from photohive_dsp_tpu.parallel.spatial import sharded_polar_tables
    budget = 24_000_000
    t4k = blur.PolarTables.for_shape(2160, 3840, CFG,
                                     max_table_bytes=budget)
    assert t4k.pad_index is None
    t1080 = blur.PolarTables.for_shape(1080, 1920, CFG,
                                       max_table_bytes=budget)
    assert t1080.pad_index is not None
    st = sharded_polar_tables(2160, 3840, CFG.angle_partitions,
                              CFG.radius_partitions, 2,
                              max_table_bytes=budget)
    assert st.flat_route and st.pad_index.shape == (2, 1, 1)
    st_small = sharded_polar_tables(480, 640, CFG.angle_partitions,
                                    CFG.radius_partitions, 2,
                                    max_table_bytes=budget)
    assert not st_small.flat_route


def test_polar_table_budget_env_override(monkeypatch):
    """PHOTOHIVE_POLAR_TABLE_MB overrides the 256 MB default budget."""
    monkeypatch.setenv("PHOTOHIVE_POLAR_TABLE_MB", "0.05")
    assert blur._pad_table_budget() == 50_000
    t = blur.PolarTables.for_shape(480, 640, CFG)
    assert t.pad_index is None  # 0.05 MB forces the flat route
    monkeypatch.delenv("PHOTOHIVE_POLAR_TABLE_MB")
    assert blur._pad_table_budget() == 256_000_000
    assert blur.PolarTables.for_shape(480, 640, CFG).pad_index is not None
