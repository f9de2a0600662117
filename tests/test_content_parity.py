"""The batched path against the float64 golden across image content.

One shape (360x480), many kinds of content: each content runs alone
through BatchRunner.run_u8 (so the palette tier switch sees that content
only) with no crop boxes, with two boxes (one on the image edge) and with
all ten (a 3x3 box among them, the masked sharpness route).  Every field
is held to the bounds chip_smoke.py holds the card to, and the palette
tier each content takes is pinned."""

import numpy as np
import pytest

import chip_smoke as cs
from photohive_dsp_tpu import ReportConfig
from photohive_dsp_tpu.models.batch import BatchRunner
from photohive_dsp_tpu.ops import quantize
from tests import golden_ref as gold
from tests.util import directional_blur_image, structured_image

H, W = 360, 480
BOX_SETS = {"0": [], "2+edge": [(40, 200, 0, 150), (180, 330, 240, 470)],
            "10": cs.ten_boxes(H, W)}


def _u8(planar):
    return np.moveaxis(np.round(np.asarray(planar) * 255.0)
                       .astype(np.uint8), 0, -1)


def _hsv_u8(h, s, v):
    """uint8 RGB of one HSV colour (h in degrees)."""
    c = v * s
    x = c * (1 - abs((h / 60.0) % 2 - 1))
    m = v - c
    r, g, b = [(c, x, 0), (x, c, 0), (0, c, x), (0, x, c), (x, 0, c),
               (c, 0, x)][int(h // 60) % 6]
    return np.round((np.array([r, g, b]) + m) * 255.0).astype(np.uint8)


def _tie_heavy():
    """18 equal hue bands at one (s, v) cell and 2% grey pixels: the grey
    cell is no parent and lies at exactly the same distance from all 18
    hue parents, so its pixels take the per-pixel tie-break with 18
    candidates — more than 8, the q_full tier."""
    img = np.empty((H, W, 3), np.uint8)
    edges = np.linspace(0, W, 19).astype(int)
    for k in range(18):
        img[:, edges[k]:edges[k + 1]] = _hsv_u8(20.0 * k + 10.0, 0.55, 0.55)
    img[:7, :] = 128          # 7 of 360 rows: 1.9% grey
    return img


def _gradient():
    y, x = np.mgrid[0:H, 0:W].astype(np.float64)
    return _u8(np.stack([x / W, y / H, 1.0 - x / W]))


CONTENTS = {
    "structured_a": lambda: _u8(structured_image(H, W, seed=5)),
    "structured_b": lambda: _u8(structured_image(H, W, seed=9)),
    "directional_blur": lambda: _u8(directional_blur_image(H, W, seed=1)),
    "noise": lambda: np.random.default_rng(4).integers(0, 256, (H, W, 3),
                                                       np.uint8),
    "tie_heavy": _tie_heavy,
    "flat_grey": lambda: np.full((H, W, 3), 128, np.uint8),
    "black": lambda: np.zeros((H, W, 3), np.uint8),
    "saturated_hue": lambda: np.broadcast_to(
        np.array([255, 0, 0], np.uint8), (H, W, 3)).copy(),
    "gradient": _gradient,
}
# q=1: no populated cell tied; q=8: some tied, at most 8 candidates;
# q_full: a populated cell with more than 8 candidates.
TIERS = {"structured_a": 0, "structured_b": 0, "directional_blur": 0,
         "noise": 1, "tie_heavy": 2, "flat_grey": 0, "black": 0,
         "saturated_hue": 0, "gradient": 2}


@pytest.fixture(scope="module")
def results():
    """Per content: the image, its golden (ten boxes) and its reports
    under each box set."""
    runner = BatchRunner(ReportConfig())
    out = {}
    for name, make in CONTENTS.items():
        img = make()
        reports = {}
        for key, blist in BOX_SETS.items():
            boxes, valid = cs.box_arrays(blist, 1)
            reports[key] = cs.data_fields(
                runner.run_u8(img[None], boxes, valid), 0, len(blist))
        out[name] = (img, cs.golden_fields(img, BOX_SETS["10"]), reports)
    return out


def _assert_rows(rows):
    misses = [(n, v, b) for n, v, ok, b in rows if not ok]
    assert not misses, misses


@pytest.mark.parametrize("content", CONTENTS)
@pytest.mark.parametrize("field", ["stats", "palette", "blur"])
def test_field_matches_golden(results, content, field):
    _, ref, reports = results[content]
    _assert_rows(cs.CHECKS[field](ref, reports["2+edge"]))


@pytest.mark.parametrize("content", CONTENTS)
@pytest.mark.parametrize("box_set", BOX_SETS)
def test_sharpness_matches_golden(results, content, box_set):
    img, ref, reports = results[content]
    blist = BOX_SETS[box_set]
    rgb = np.moveaxis(img, -1, 0).astype(np.float64) / 255.0
    ref = dict(ref, sharp=gold.variance_sharpness(gold.rgb2pgm(*rgb), blist)
               if blist else np.zeros(0))
    _assert_rows(cs.check_sharpness(ref, reports[box_set]))


@pytest.mark.parametrize("content", CONTENTS)
def test_palette_tier(content):
    """palette_tier, the predicate palette_q_tiers switches on."""
    import jax
    import jax.numpy as jnp

    from photohive_dsp_tpu.ops.colorspace import rgb_to_hsv, u8_to_unit_f32

    cfg = ReportConfig()
    rgb = u8_to_unit_f32(jnp.moveaxis(jnp.asarray(CONTENTS[content]()),
                                      -1, 0))
    h, s, v = rgb_to_hsv(rgb[0], rgb[1], rgb[2])
    cells = quantize.assign_cells(h, s, v, cfg).reshape(-1)
    counts = quantize.cell_counts(cells, cfg.num_cells)
    assign = quantize.parent_assignment(
        counts, H * W, cfg, quantize.OctreeTables.for_config(cfg))
    tier = jax.jit(lambda a, c: quantize.palette_tier(a, c, cfg))(
        assign, counts)
    assert int(tier) == TIERS[content]
