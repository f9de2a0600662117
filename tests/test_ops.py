"""Parity tests for the elementwise / reduction / stencil ops vs the float64
golden emulation of the C reference."""

import numpy as np
import pytest

import jax.numpy as jnp

from photohive_dsp_tpu.ops import colorspace, filtering, sharpness, stats
from . import golden_ref as gold
from .util import snr_db, structured_image


@pytest.fixture(scope="module")
def img():
    return structured_image(480, 640)


def test_rgb2hsv_parity(img):
    h, s, v = colorspace.rgb_to_hsv(*(jnp.asarray(c, jnp.float32) for c in img))
    gh, gs, gv = gold.rgb2hsv(*img)
    assert snr_db(gh, np.asarray(h)) > 55
    assert snr_db(gs, np.asarray(s)) > 55
    assert snr_db(gv, np.asarray(v)) > 55
    assert float(jnp.max(v)) <= 0.999999
    assert float(jnp.max(s)) <= 0.999999
    assert float(jnp.min(h)) >= 0 and float(jnp.max(h)) < 360


def test_rgb2hsv_clamps():
    # max==1 -> v clamps; delta==max -> s clamps (reference
    # src/image_processing.c:408-414).
    r = jnp.asarray([[1.0, 0.5]], jnp.float32)
    g = jnp.asarray([[0.0, 0.5]], jnp.float32)
    b = jnp.asarray([[0.0, 0.5]], jnp.float32)
    h, s, v = colorspace.rgb_to_hsv(r, g, b)
    assert np.asarray(v)[0, 0] == np.float32(0.999999)
    assert np.asarray(s)[0, 0] == np.float32(0.999999)
    assert np.asarray(s)[0, 1] == 0.0  # gray pixel
    assert np.asarray(h)[0, 1] == 0.0


def test_hsv_roundtrip(img):
    h, s, v = colorspace.rgb_to_hsv(*(jnp.asarray(c, jnp.float32) for c in img))
    r, g, b = colorspace.hsv_to_rgb(h, s, v)
    # clamps limit roundtrip accuracy to ~1e-6 except on clamped pixels
    for ours, ref in zip((r, g, b), img):
        assert snr_db(ref, np.asarray(ours)) > 50


def test_pgm_parity(img):
    pgm = colorspace.rgb_to_pgm(*(jnp.asarray(c, jnp.float32) for c in img))
    assert snr_db(gold.rgb2pgm(*img), np.asarray(pgm)) > 60


def test_downsample_quirk(img):
    for rate in (2, 3, 4):
        ours = np.asarray(colorspace.downsample_rgb(
            jnp.asarray(img, jnp.float32), rate))
        ref = gold.downsample_rgb(img, rate)
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, atol=1e-7)


def test_rgb_statistics(img):
    ours = np.asarray(stats.rgb_statistics(
        *(jnp.asarray(c, jnp.float32) for c in img)))
    ref = gold.rgb_statistics(*img)
    assert snr_db(ref, ours) > 60


def test_laplacian_zero_pad(img):
    pgm = gold.rgb2pgm(*img)
    ours = np.asarray(filtering.laplacian_3x3(jnp.asarray(pgm, jnp.float32)))
    ref = gold.laplacian_filter(pgm)
    assert snr_db(ref, ours) > 50
    # border semantics: corner response must reflect zero padding
    assert abs(ours[0, 0] - ref[0, 0]) < 1e-4


def test_trailing_circular_box():
    x = np.arange(12, dtype=np.float64)
    ours = np.asarray(filtering.trailing_circular_box(
        jnp.asarray(x, jnp.float32), 5))
    ref = gold.trailing_circular_box(x, 5)
    np.testing.assert_allclose(ours, ref, rtol=1e-6)


def test_variance_sharpness(img):
    pgm64 = gold.rgb2pgm(*img)
    boxes_list = [(40, 200, 60, 300), (0, 480, 0, 640), (100, 131, 200, 233)]
    ref = gold.variance_sharpness(pgm64, boxes_list)
    boxes = np.zeros((10, 4), np.int32)
    valid = np.zeros((10,), bool)
    for i, bb in enumerate(boxes_list):
        boxes[i] = bb
        valid[i] = True
    ours = np.asarray(sharpness.variance_sharpness(
        jnp.asarray(pgm64, jnp.float32), jnp.asarray(boxes),
        jnp.asarray(valid)))
    # The mean uses the exact telescoped ring sum (ops/sharpness.py
    # _ring_weight_map), so f32 tracks the f64 golden to ~1e-7 relative.
    np.testing.assert_allclose(ours[:3], ref, rtol=1e-5)
    assert np.all(ours[3:] == 0.0)

    # The batched shared-response + ring-correction formulation must agree
    # with the same float64 golden directly (not only with the masked path).
    fast = np.asarray(sharpness.variance_sharpness_batched(
        jnp.asarray(pgm64, jnp.float32)[None], jnp.asarray(boxes)[None],
        jnp.asarray(valid)[None]))[0]
    np.testing.assert_allclose(fast[:3], ref, rtol=1e-5)
    np.testing.assert_allclose(fast[:3], ours[:3], rtol=1e-5)
    assert np.all(fast[3:] == 0.0)


def test_variance_sharpness_zero_mean_unguarded():
    """var/mean is unguarded, like the reference's double division
    (src/filtering.c:174) and the f64 golden.

    A fully flat crop: response mean and variance are exactly 0 in every
    formulation -> 0/0 = NaN on both sides (the reference propagates it;
    Report only scrubs blur *bins*, core.py:100-117).

    A crop whose 1-px border ring is zero but whose interior is not is
    ill-conditioned: the true response mean is 0, so the quotient blows
    up on both sides — the golden's direct f64 summation leaves ~1e-16
    cancellation residue (quotient ~1e16 finite) while our telescoped
    border-ring sum is exactly 0 (quotient +inf).  Both are 'huge'; the
    discrete difference is inherent to the formulation and covered by
    the TINY/ill-conditioned notes in ops/sharpness.py."""
    rng = np.random.default_rng(3)
    t, b, l, r = 20, 30, 20, 30
    boxes = np.zeros((10, 4), np.int32)
    boxes[0] = (t, b, l, r)
    valid = np.zeros((10,), bool)
    valid[0] = True

    flat = np.zeros((64, 64), np.float64)
    with np.errstate(invalid="ignore"):
        ref = gold.variance_sharpness(flat, [(t, b, l, r)])
    assert np.isnan(ref[0])
    ours = np.asarray(sharpness.variance_sharpness(
        jnp.asarray(flat, jnp.float32), jnp.asarray(boxes),
        jnp.asarray(valid)))
    fast = np.asarray(sharpness.variance_sharpness_batched(
        jnp.asarray(flat, jnp.float32)[None], jnp.asarray(boxes)[None],
        jnp.asarray(valid)[None]))[0]
    assert np.isnan(ours[0]) and np.isnan(fast[0])
    assert np.all(ours[1:] == 0.0) and np.all(fast[1:] == 0.0)

    ring0 = np.zeros((64, 64), np.float64)
    ring0[t + 1:b - 1, l + 1:r - 1] = \
        rng.random((b - t - 2, r - l - 2)) + 0.1
    with np.errstate(divide="ignore"):
        ref = gold.variance_sharpness(ring0, [(t, b, l, r)])
    ours = np.asarray(sharpness.variance_sharpness(
        jnp.asarray(ring0, jnp.float32), jnp.asarray(boxes),
        jnp.asarray(valid)))
    assert abs(ref[0]) > 1e12                 # golden: astronomically large
    assert np.isinf(ours[0]) or abs(ours[0]) > 1e12


def test_u8_to_unit_f32_exact():
    """The device ingest sequence == correctly rounded x/255.0 for all
    256 inputs, on this backend's IEEE mul/add (division-free)."""
    import jax

    x = jnp.asarray(np.arange(256, dtype=np.uint8))
    got = np.asarray(jax.jit(colorspace.u8_to_unit_f32)(x))
    want = np.arange(256, dtype=np.float32) / np.float32(255.0)
    assert np.array_equal(got, want)
