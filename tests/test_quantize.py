"""Parity tests for the HSV-grid color quantizer vs the golden emulation."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from photohive_dsp_tpu.config import ReportConfig
from photohive_dsp_tpu.ops import quantize
from photohive_dsp_tpu.ops.geometry import octree_geometry
from . import golden_ref as gold
from .util import snr_db

CFG = ReportConfig()


def safe_hsv(n=40000, seed=0):
    """HSV samples placed away from cell boundaries so f32 and f64 paths
    agree on cell assignment (boundary pixels are legitimately ambiguous
    under dtype change and are covered by the end-to-end SNR test)."""
    rng = np.random.default_rng(seed)
    h = rng.integers(0, 360, n) + 0.5
    s = np.clip(rng.integers(0, 40, n) / 40.0 + 0.0125, 0, 0.999999)
    v = np.clip(rng.integers(0, 40, n) / 40.0 + 0.0125, 0, 0.999999)
    return h.astype(np.float64), s, v


def golden_octree():
    return gold.GoldenOctree(CFG.h_partitions, CFG.s_partitions,
                             CFG.v_partitions, CFG.black_thresh,
                             CFG.gray_thresh, CFG.coverage_thresh,
                             CFG.quantity_weight, CFG.saturation_value_weight)


def test_cell_centers_match():
    geom = octree_geometry(CFG)
    oct_ = golden_octree()
    np.testing.assert_allclose(geom.centers, oct_.centers, atol=0)


def test_assign_cells_matches():
    h, s, v = safe_hsv()
    oct_ = golden_octree()
    ref = oct_.assign(h, s, v)
    ours = np.asarray(quantize.assign_cells(
        jnp.asarray(h, jnp.float32), jnp.asarray(s, jnp.float32),
        jnp.asarray(v, jnp.float32), CFG)).ravel()
    assert (ref == ours).mean() > 0.999  # f32 rounding may move a stray pixel
    # all grays collapse into the first gray cell (premature-cast quirk)
    gray_mask = (s < CFG.gray_thresh) & (v >= CFG.black_thresh)
    assert np.all(ours[gray_mask] == CFG.gray_start)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_margin_insertion_sort_matches(seed):
    """The jitted margin-comparator insertion sort must reproduce the C
    insertion sort exactly, including non-transitive near-tie behavior."""
    rng = np.random.default_rng(seed)
    c = CFG.num_cells
    counts = rng.integers(0, 50, c)
    counts[rng.integers(0, c, 20)] = 0           # empty cells
    counts[rng.integers(0, c, 10)] = 7           # forced quantity ties
    oct_ = golden_octree()
    ref_order = oct_.sort_ids(counts)
    geom = octree_geometry(CFG)
    sal = quantize.saliency_f32(jnp.asarray(counts, jnp.int32),
                                jnp.asarray(geom.s_v_f32), CFG)
    ours = np.asarray(quantize.margin_insertion_argsort(sal))
    np.testing.assert_array_equal(ours, np.array(ref_order))


def test_palette_matches_golden():
    h, s, v = safe_hsv(60000, seed=42)
    oct_ = golden_octree()
    ref_avg, ref_pct, ref_ids = oct_.palette(h, s, v)

    tables = quantize.OctreeTables.for_config(CFG)
    res = quantize.color_palette(
        jnp.asarray(h, jnp.float32).reshape(200, 300),
        jnp.asarray(s, jnp.float32).reshape(200, 300),
        jnp.asarray(v, jnp.float32).reshape(200, 300), CFG, tables)
    n = int(res.n_valid)
    assert n == len(ref_ids)
    np.testing.assert_array_equal(np.asarray(res.parent_ids)[:n], ref_ids)
    assert snr_db(ref_pct, np.asarray(res.percentages)[:n]) > 55
    assert snr_db(ref_avg, np.asarray(res.hsv)[:n]) > 50


def test_palette_percentages_sum_and_ranges():
    h, s, v = safe_hsv(60000, seed=7)
    tables = quantize.OctreeTables.for_config(CFG)
    res = quantize.color_palette(
        jnp.asarray(h, jnp.float32).reshape(200, 300),
        jnp.asarray(s, jnp.float32).reshape(200, 300),
        jnp.asarray(v, jnp.float32).reshape(200, 300), CFG, tables)
    n = int(res.n_valid)
    pct = np.asarray(res.percentages)
    hsv = np.asarray(res.hsv)
    # every pixel is assigned to exactly one parent -> percentages sum to 1
    assert abs(pct[:n].sum() - 1.0) < 1e-4
    assert np.all(pct[n:] == 0)
    assert np.all(hsv[:n, 0] >= 0) and np.all(hsv[:n, 0] <= 360)
    assert np.all(hsv[:n, 1] >= 0) and np.all(hsv[:n, 1] <= 1)
    assert np.all(hsv[:n, 2] >= 0) and np.all(hsv[:n, 2] <= 1)


def test_tied_cells_per_pixel_branch():
    """Craft a case where a non-parent cell is exactly equidistant between
    two valid parents, exercising the per-pixel reassignment branch."""
    # Hue cells at centers 10, 30, 50 (Lh=20).  Fill cells 0 and 2 heavily
    # (parents) and put a few pixels in cell 1, half nearer each parent.
    n_big = 20000
    h = np.concatenate([
        np.full(n_big, 10.5), np.full(n_big, 50.5),
        np.array([22.0, 23.0, 37.0, 38.0]),  # cell 1, split by hue midpoint
    ])
    s = np.full(h.shape, 0.55)
    v = np.full(h.shape, 0.55)
    oct_ = golden_octree()
    ref_avg, ref_pct, ref_ids = oct_.palette(h, s, v)

    tables = quantize.OctreeTables.for_config(CFG)
    res = quantize.color_palette(
        jnp.asarray(h, jnp.float32).reshape(1, -1),
        jnp.asarray(s, jnp.float32).reshape(1, -1),
        jnp.asarray(v, jnp.float32).reshape(1, -1), CFG, tables)
    n = int(res.n_valid)
    assert n == len(ref_ids)
    np.testing.assert_array_equal(np.asarray(res.parent_ids)[:n], ref_ids)
    np.testing.assert_allclose(np.asarray(res.percentages)[:n], ref_pct,
                               atol=1e-7)
    np.testing.assert_allclose(np.asarray(res.hsv)[:n], ref_avg, atol=2e-3)


def test_saliency_argsort_big_c_routes_to_fori_loop():
    """Large-C configs (h_partitions=360 -> C=2164) sort exactly through
    the fori_loop margin sort: 2163 dependent steps, each reproducing the
    reference's truncating comparator.  Python insertion-sort emulation
    is the spec."""
    big = quantize.ReportConfig(h_partitions=360)
    big.validate()
    c = big.num_cells
    assert c == 2164
    rng = np.random.default_rng(11)
    sal = (rng.integers(0, 60, c) + rng.random(c) * 0.8).astype(np.float32)
    ours = np.asarray(jax.vmap(quantize.margin_insertion_argsort)(
        jnp.asarray(sal)[None]))[0]
    order = list(range(c))
    for i in range(1, c):
        j = i
        while j > 0 and int(np.float32(sal[order[j - 1]])
                            - np.float32(sal[order[j]])) < 0:
            order[j - 1], order[j] = order[j], order[j - 1]
            j -= 1
    np.testing.assert_array_equal(ours, np.array(order))


def test_pixel_sums_narrow_wide_equivalence():
    """The batched XLA q8/q40 cond (color_palette_batched): when no
    populated cell has more than 8 candidates, the narrow q_pad=8 pass
    must produce bit-identical sums to the full-width default (extra
    candidate slots are sentinels for every populated cell)."""
    import jax

    cfg = ReportConfig()
    tables = quantize.OctreeTables.for_config(cfg)
    c = cfg.num_cells
    rng = np.random.default_rng(3)
    h = jnp.asarray(rng.random((1, 48, 64)) * 360, jnp.float32)
    s = jnp.asarray(rng.random((1, 48, 64)) * 0.999, jnp.float32)
    v = jnp.asarray(rng.random((1, 48, 64)) * 0.999, jnp.float32)
    cells = jax.vmap(lambda a, b2, c2: quantize.assign_cells(
        a, b2, c2, cfg))(h, s, v).reshape(1, -1)
    counts = jax.vmap(lambda x: quantize.cell_counts(x, c))(cells)
    assign = jax.vmap(lambda cnt: quantize.parent_assignment(
        cnt, 48 * 64, cfg, tables))(counts)
    ncand = jnp.sum(assign.allowed, axis=-1)
    q_needed = int(jnp.max(jnp.where(counts > 0, ncand, 0)))
    assert q_needed <= 8, "fixture must exercise the narrow predicate"
    args = (h, s, v, cells, assign)
    narrow = jax.vmap(lambda hh, ss, vv, cc2, a: quantize.palette_pixel_sums(
        hh, ss, vv, cc2, a, cfg, tables, q_pad=8))(*args)
    wide = jax.vmap(lambda hh, ss, vv, cc2, a: quantize.palette_pixel_sums(
        hh, ss, vv, cc2, a, cfg, tables))(*args)
    np.testing.assert_array_equal(np.asarray(narrow), np.asarray(wide))


def test_pixel_sums_q1_equivalence():
    """q_pad=1 tier (no populated tied cell): pure parent-lookup pass
    must match the full-width default bit-for-bit on a structured image
    (whose q_needed is 1 — asserted)."""
    import jax

    from .util import structured_image

    cfg = ReportConfig()
    tables = quantize.OctreeTables.for_config(cfg)
    c = cfg.num_cells
    img = structured_image(96, 128, seed=7)
    from photohive_dsp_tpu.ops.colorspace import rgb_to_hsv
    h, s, v = rgb_to_hsv(jnp.asarray(img[0]), jnp.asarray(img[1]),
                         jnp.asarray(img[2]))
    h, s, v = h[None], s[None], v[None]
    cells = jax.vmap(lambda a, b2, c2: quantize.assign_cells(
        a, b2, c2, cfg))(h, s, v).reshape(1, -1)
    counts = jax.vmap(lambda x: quantize.cell_counts(x, c))(cells)
    assign = jax.vmap(lambda cnt: quantize.parent_assignment(
        cnt, 96 * 128, cfg, tables))(counts)
    ncand = jnp.sum(assign.allowed, axis=-1)
    assert int(jnp.max(jnp.where(counts > 0, ncand, 0))) <= 1
    args = (h, s, v, cells, assign)
    q1 = jax.vmap(lambda hh, ss, vv, cc2, a: quantize.palette_pixel_sums(
        hh, ss, vv, cc2, a, cfg, tables, q_pad=1))(*args)
    wide = jax.vmap(lambda hh, ss, vv, cc2, a: quantize.palette_pixel_sums(
        hh, ss, vv, cc2, a, cfg, tables))(*args)
    np.testing.assert_array_equal(np.asarray(q1), np.asarray(wide))


@pytest.mark.parametrize("kw", [
    dict(h_partitions=4),                       # q_full=16, C=28
    dict(h_partitions=36),                      # q_full=80, C=220
    dict(s_partitions=3, v_partitions=3),       # q_full=56, C=166
    dict(h_partitions=12, s_partitions=1, v_partitions=1),  # C=14
])
def test_palette_tiers_nondefault_configs(kw):
    """The q=1/8/full tier arithmetic must hold for every legal config
    (q_full varies 16..80 here): the batched tiered route must match the
    unconditional full-width pass exactly on both a no-tie structured
    image and a uniform-noise image (which forces the tied branch)."""
    import jax

    from photohive_dsp_tpu.ops.colorspace import rgb_to_hsv
    from .util import structured_image

    cfg = ReportConfig(**kw)
    cfg.validate()
    tables = quantize.OctreeTables.for_config(cfg)
    c = cfg.num_cells
    rng = np.random.default_rng(5)
    imgs = np.stack([structured_image(72, 96, seed=2),
                     rng.random((3, 72, 96)).astype(np.float32)])
    h, s, v = jax.vmap(lambda x: rgb_to_hsv(x[0], x[1], x[2]))(
        jnp.asarray(imgs, jnp.float32))
    tiered = quantize.color_palette_batched(h, s, v, cfg, tables)
    # Unconditional full-width reference pass (no tier switch).
    cells = jax.vmap(lambda a, b2, c2: quantize.assign_cells(
        a, b2, c2, cfg))(h, s, v).reshape(2, -1)
    counts = jax.vmap(lambda x: quantize.cell_counts(x, c))(cells)
    assign = jax.vmap(lambda cnt: quantize.parent_assignment(
        cnt, 72 * 96, cfg, tables))(counts)
    sums = jax.vmap(lambda hh, ss, vv, cc2, a: quantize.palette_pixel_sums(
        hh, ss, vv, cc2, a, cfg, tables))(h, s, v, cells, assign)
    ref = jax.vmap(lambda sm, a: quantize.palette_finalize(
        sm, a, 72 * 96, tables))(sums, assign)
    for name in tiered._fields:
        np.testing.assert_array_equal(np.asarray(getattr(tiered, name)),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=f"{kw}:{name}")


def test_huge_c_config_end_to_end():
    """Largest legal config (h_partitions=360 -> C=2164, q_full=728):
    the whole public API must work, not just the routed sort — the
    candidate table, tier switch, and finalize all scale with C."""
    import photohive_dsp_tpu as ph

    img = np.random.default_rng(0).integers(0, 256, (360, 480, 3),
                                            np.uint8)
    rep = ph.get_report(img, h_partitions=360)
    assert rep is not None
    pct = np.asarray(rep.color_palette.quantities)
    assert np.isfinite(pct).all() and abs(pct.sum() - 1.0) < 1e-4
    hsv = np.asarray(rep.color_palette.colors)
    assert np.isfinite(hsv).all()


@pytest.mark.parametrize("n_px,n_seg", [(1, 3), (1000, 7), (1 << 16, 113)])
def test_bucket_sums_match_float64(n_px, n_seg):
    """The palette's masked-reduction bucket sums equal float64 sums per
    segment to f32 rounding, count exactly, and drop out-of-range ids."""
    rng = np.random.default_rng(n_px)
    vals = np.stack([rng.uniform(0, 360, n_px), rng.uniform(0, 1, n_px),
                     rng.uniform(0, 1, n_px)], 1).astype(np.float32)
    seg = rng.integers(0, n_seg + 1, n_px).astype(np.int32)  # n_seg: drop
    got = np.asarray(jax.jit(quantize._bucket_sums, static_argnums=2)(
        vals, seg, n_seg))
    assert got.shape == (n_seg, 4) and got.dtype == np.float32
    for k in range(n_seg):
        rows = vals[seg == k].astype(np.float64)
        assert got[k, 3] == len(rows)
        np.testing.assert_allclose(got[k, :3], rows.sum(0), rtol=2e-6,
                                   atol=1e-5)
