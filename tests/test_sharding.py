"""Sharded-path parity on a virtual 8-device CPU mesh: the spatially-sharded
and data-parallel pipelines must reproduce the single-device report."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import photohive_dsp_tpu as ph
from photohive_dsp_tpu.models.pipeline import jitted_full_report
from photohive_dsp_tpu.parallel import mesh as meshlib
from photohive_dsp_tpu.parallel.sharding import data_parallel_report
from photohive_dsp_tpu.parallel.spatial import (build_dp_spatial_report,
                                                build_spatial_report)
from .util import snr_db, structured_image

CFG = ph.ReportConfig()


@pytest.fixture(scope="module")
def single_device_report():
    img = structured_image(480, 640, seed=5)
    boxes, valid = ph.set_bounding_boxes([
        dict(top=40, bottom=200, left=60, right=300),
        dict(top=230, bottom=470, left=100, right=630),  # spans shards
    ])
    fn, tables = jitted_full_report(480, 640, CFG)
    data = fn(jnp.asarray(img, jnp.float32), jnp.asarray(boxes),
              jnp.asarray(valid), tables)
    return img, boxes, valid, data


def _assert_reports_match(ref, ours, bins_snr=55):
    np.testing.assert_allclose(np.asarray(ours.rgb_stats),
                               np.asarray(ref.rgb_stats), rtol=2e-5, atol=1e-6)
    assert abs(float(ours.average_saturation)
               - float(ref.average_saturation)) < 1e-5
    assert int(ours.palette_n) == int(ref.palette_n)
    n = int(ref.palette_n)
    np.testing.assert_array_equal(np.asarray(ours.palette_ids)[:n],
                                  np.asarray(ref.palette_ids)[:n])
    np.testing.assert_allclose(np.asarray(ours.palette_pct)[:n],
                               np.asarray(ref.palette_pct)[:n], atol=1e-6)
    np.testing.assert_allclose(np.asarray(ours.palette_hsv)[:n],
                               np.asarray(ref.palette_hsv)[:n],
                               rtol=1e-4, atol=1e-3)
    assert snr_db(np.asarray(ref.blur_bins),
                  np.asarray(ours.blur_bins)) > bins_snr
    np.testing.assert_array_equal(np.asarray(ours.blur_vector_angles),
                                  np.asarray(ref.blur_vector_angles))
    np.testing.assert_allclose(np.asarray(ours.blur_vector_mags),
                               np.asarray(ref.blur_vector_mags), atol=1e-5)
    # Both sides use the exact telescoped ring-sum mean, so sharded vs
    # single-device agreement is f32-rounding tight.
    np.testing.assert_allclose(np.asarray(ours.sharpness),
                               np.asarray(ref.sharpness), rtol=1e-5,
                               atol=1e-6)


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_spatial_report_matches_single_device(single_device_report):
    img, boxes, valid, ref = single_device_report
    m = meshlib.make_mesh(data=1, spatial=8)
    fn = build_spatial_report(m, 480, 640, CFG)
    ours = fn(jnp.asarray(img, jnp.float32), jnp.asarray(boxes),
              jnp.asarray(valid))
    _assert_reports_match(ref, ours)


def test_data_parallel_batch_matches(single_device_report):
    img, boxes, valid, ref = single_device_report
    m = meshlib.make_mesh(data=8, spatial=1)
    fn, tables = data_parallel_report(480, 640, CFG, m)
    batch = jnp.broadcast_to(jnp.asarray(img, jnp.float32), (8, 3, 480, 640))
    bboxes = jnp.broadcast_to(jnp.asarray(boxes), (8, 10, 4))
    bvalid = jnp.broadcast_to(jnp.asarray(valid), (8, 10))
    out = fn(batch, bboxes, bvalid, tables)
    for i in (0, 7):
        one = jax.tree.map(lambda x: x[i], out)
        _assert_reports_match(ref, one, bins_snr=90)


def test_dp_spatial_full_step(single_device_report):
    img, boxes, valid, ref = single_device_report
    m = meshlib.make_mesh(data=2, spatial=4)
    fn = build_dp_spatial_report(m, 2, 480, 640, CFG)
    batch = jnp.broadcast_to(jnp.asarray(img, jnp.float32), (2, 3, 480, 640))
    bboxes = jnp.broadcast_to(jnp.asarray(boxes), (2, 10, 4))
    bvalid = jnp.broadcast_to(jnp.asarray(valid), (2, 10))
    out = fn(batch, bboxes, bvalid)
    for i in (0, 1):
        one = jax.tree.map(lambda x: x[i], out)
        _assert_reports_match(ref, one)


def test_spatial_report_downsampled_matches_single_device():
    """downsample_rate=2: decimation happens at jit level (the reference's
    stride-(rate-1) row pick is not shard-aligned) and the decimated image
    reshards onto the spatial axis for the palette/saturation stages."""
    cfg = ph.ReportConfig(downsample_rate=2)
    img = structured_image(480, 640, seed=7)
    boxes, valid = ph.set_bounding_boxes([
        dict(top=40, bottom=200, left=60, right=300),
    ])
    fn0, tables = jitted_full_report(480, 640, cfg)
    ref = fn0(jnp.asarray(img, jnp.float32), jnp.asarray(boxes),
              jnp.asarray(valid), tables)
    m = meshlib.make_mesh(data=1, spatial=8)   # 480/2=240 divides 8
    fn = build_spatial_report(m, 480, 640, cfg)
    ours = fn(jnp.asarray(img, jnp.float32), jnp.asarray(boxes),
              jnp.asarray(valid))
    _assert_reports_match(ref, ours)


def test_spatial_report_non_dividing_height():
    """H=487 does not divide the 8-way spatial axis: rows are zero-padded
    to 488 and masked (stats deviations, sentinel palette cells, H-point
    column FFT slice).  Must match the single-device report on the real
    487x640 image, including a crop box touching the true bottom edge."""
    img = structured_image(487, 640, seed=11)
    boxes, valid = ph.set_bounding_boxes([
        dict(top=40, bottom=200, left=60, right=300),
        dict(top=300, bottom=487, left=100, right=630),  # bottom edge
    ])
    fn0, tables = jitted_full_report(487, 640, CFG)
    ref = fn0(jnp.asarray(img, jnp.float32), jnp.asarray(boxes),
              jnp.asarray(valid), tables)
    m = meshlib.make_mesh(data=1, spatial=8)
    fn = build_spatial_report(m, 487, 640, CFG)
    ours = fn(jnp.asarray(img, jnp.float32), jnp.asarray(boxes),
              jnp.asarray(valid))
    _assert_reports_match(ref, ours)


def test_spatial_report_non_dividing_downsampled():
    """downsample_rate=2 with H=487: full-res pad (488) and decimated pad
    (243 -> 248) are masked independently."""
    cfg = ph.ReportConfig(downsample_rate=2)
    img = structured_image(487, 640, seed=12)
    boxes, valid = ph.set_bounding_boxes([
        dict(top=40, bottom=200, left=60, right=300),
    ])
    fn0, tables = jitted_full_report(487, 640, cfg)
    ref = fn0(jnp.asarray(img, jnp.float32), jnp.asarray(boxes),
              jnp.asarray(valid), tables)
    m = meshlib.make_mesh(data=1, spatial=8)
    fn = build_spatial_report(m, 487, 640, cfg)
    ours = fn(jnp.asarray(img, jnp.float32), jnp.asarray(boxes),
              jnp.asarray(valid))
    _assert_reports_match(ref, ours)


def test_halo_exchange_box_on_boundary():
    """A 2-row-tall box straddling a shard boundary must match exactly."""
    img = structured_image(480, 640, seed=13)
    boxes, valid = ph.set_bounding_boxes([
        dict(top=59, bottom=61, left=10, right=630),  # rows 59-60: boundary
    ])
    fn0, tables = jitted_full_report(480, 640, CFG)
    ref = fn0(jnp.asarray(img, jnp.float32), jnp.asarray(boxes),
              jnp.asarray(valid), tables)
    m = meshlib.make_mesh(data=1, spatial=8)   # shard height 60
    fn = build_spatial_report(m, 480, 640, CFG)
    ours = fn(jnp.asarray(img, jnp.float32), jnp.asarray(boxes),
              jnp.asarray(valid))
    np.testing.assert_allclose(np.asarray(ours.sharpness)[:1],
                               np.asarray(ref.sharpness)[:1], rtol=1e-5)


def test_sharded_sharpness_thin_and_edge_boxes():
    """1-px-thin boxes and boxes touching image edges are exact in the
    shared-response formulation (explicit overlap cross terms); pinned
    against the float64 golden."""
    from tests import golden_ref as gold

    img = structured_image(480, 640, seed=21)
    pgm64 = gold.rgb2pgm(*img)
    boxes_list = [(100, 101, 50, 600),   # 1-px tall
                  (0, 480, 320, 321),    # 1-px wide, full height
                  (0, 2, 0, 640),        # 2-px tall at top edge
                  (59, 61, 59, 61),      # 2x2 straddling a shard boundary
                  (119, 120, 119, 120)]  # single pixel at a boundary
    ref = gold.variance_sharpness(pgm64, boxes_list)
    boxes = np.zeros((10, 4), np.int32)
    valid = np.zeros((10,), bool)
    for i, bb in enumerate(boxes_list):
        boxes[i] = bb
        valid[i] = True
    m = meshlib.make_mesh(data=1, spatial=8)   # shard height 60
    fn = build_spatial_report(m, 480, 640, CFG)
    ours = fn(jnp.asarray(img, jnp.float32), jnp.asarray(boxes),
              jnp.asarray(valid))
    # Tiny boxes route to the exact masked two-pass (TINY_BOX_PX cond):
    # the 1x1 box is exactly 0 and the rest are f32-rounding tight.
    np.testing.assert_allclose(np.asarray(ours.sharpness)[:5], ref,
                               rtol=1e-5)
