"""Bring-up check: the photo-report pipeline on the GPU, end to end.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: the mesh phase only

Drives the users' entry points (get_report, BatchRunner.run_u8,
run_corpus, the serving artifacts; with --four the data and data x spatial
meshes) at deployment sizes, checks every result against the float64
golden of the C reference (tests/golden_ref.py) or against the one-card
result, and prints each measured error beside its bound.  Any miss raises,
so the script exits non-zero and never prints its last line.  The last line
is one JSON object:

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

It refuses to run without a GPU (exit 1, no result line).  The phase
functions take their sizes as arguments; the CPU tests call them at tiny
sizes (tests/test_chip_smoke.py).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

# Bounds: the ones tests/test_pipeline.py holds the pipeline to.
STATS_SNR_DB = 60.0
SAT_ABS = 1e-4
BINS_SNR_DB = 35.0
VEC_MAG_ABS = 1e-5
SHARP_RTOL = 1e-4
PAL_N_DIFF = 2
PAL_JACCARD = 0.9
PAL_PCT_ABS = 2e-3
PAL_HUE_DEG = 1.5
PAL_SV_ABS = 1e-2


def require_gpu():
    """The devices, or SystemExit when JAX finds no GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX platform "
                         f"{devs[0].platform!r}); nothing was checked")
    return devs


def card_line() -> str:
    """name, power limit of each card as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return "; ".join(ln.strip() for ln in out.stdout.splitlines()
                     if ln.strip())


def _log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def structured_u8(h: int, w: int, seed: int) -> np.ndarray:
    """(H, W, 3) uint8 photo-like frame (tests/util.structured_image)."""
    from tests.util import structured_image

    img = structured_image(h, w, seed=seed)
    return np.moveaxis(np.round(img * 255.0).astype(np.uint8), 0, -1)


def noise_u8(h: int, w: int, seed: int) -> np.ndarray:
    """(H, W, 3) uint8 uniform noise: populates every palette cell."""
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


def two_boxes(h: int, w: int):
    return [(h // 10, h // 2, w // 10, w // 2),
            (h // 3, h * 9 // 10, w // 2, w * 19 // 20)]


def ten_boxes(h: int, w: int):
    """All 10 crop slots: image corners and edges, a full-height strip,
    interior boxes, and one 3x3 box (the TINY_BOX_PX route)."""
    return [(0, h // 4, 0, w // 4),                       # top-left corner
            (h * 3 // 4, h, w * 3 // 4, w),               # bottom-right
            (0, h, w // 2, w // 2 + max(8, w // 40)),     # full height
            (h // 2, h // 2 + max(8, h // 40), 0, w),     # full width
            (0, h // 8, w // 3, w * 2 // 3),              # top edge
            (h // 5, h * 2 // 5, w // 5, w * 2 // 5),
            (h // 2, h * 3 // 4, w // 8, w // 2),
            (h // 3, h * 2 // 3, w * 2 // 3, w * 7 // 8),
            (h * 5 // 8, h * 7 // 8, w * 3 // 8, w * 5 // 8),
            (h // 4, h // 4 + 3, w // 4, w // 4 + 3)]     # 3x3 box


def box_arrays(box_list, batch: int = None):
    import photohive_dsp_tpu as ph

    boxes, valid = ph.set_bounding_boxes(
        [dict(top=t, bottom=b, left=l, right=r) for t, b, l, r in box_list])
    if batch is None:
        return boxes, valid
    return (np.broadcast_to(boxes, (batch,) + boxes.shape).copy(),
            np.broadcast_to(valid, (batch,) + valid.shape).copy())


# ---------------------------------------------------------------------------
# comparison
# ---------------------------------------------------------------------------

def f32_hsv(u8: np.ndarray):
    """The float32 HSV planes of one (H, W, 3) uint8 image in plain numpy:
    the correctly rounded x/255 and the reference's HSV formulas
    (tests/golden_ref.rgb2hsv), each step rounded to float32.  Nothing of
    the package runs here, so the card's ingest and HSV are still held to
    an independent result."""
    from tests import golden_ref as gold

    rgb = [u8[..., k].astype(np.float32) / np.float32(255.0)
           for k in range(3)]
    return gold.rgb2hsv(*rgb, dtype=np.float32)


def golden_fields(u8: np.ndarray, box_list) -> dict:
    """The float64 golden report of one (H, W, 3) uint8 image."""
    from tests import golden_ref as gold

    rgb = np.moveaxis(u8, -1, 0).astype(np.float64) / 255.0
    g = gold.full_report(rgb, boxes=list(box_list))
    return dict(stats=np.asarray(g["rgb_stats"]),
                sat=float(g["average_saturation"]),
                pal_ids=list(map(int, g["palette_ids"])),
                pal_pct=np.asarray(g["palette_pct"]),
                pal_hsv=np.asarray(g["palette_hsv"]),
                sharp=np.asarray(g["sharpness"]),
                bins=np.asarray(g["blur_bins"]),
                angles=[a for a, _ in g["blur_vectors"]],
                mags=[m for _, m in g["blur_vectors"]])


def golden_palette(h, s, v) -> dict:
    """The golden quantizer's palette of the given HSV planes, in
    golden_fields' layout."""
    from tests import golden_ref as gold

    avg, pct, ids = gold.GoldenOctree().palette(h, s, v)
    return dict(pal_ids=list(map(int, ids)), pal_pct=np.asarray(pct),
                pal_hsv=np.asarray(avg))


def data_fields(data, i: int, num_boxes: int) -> dict:
    """Image ``i`` of a batched ReportData, in golden_fields' layout."""
    d = {k: np.asarray(v)[i] for k, v in data._asdict().items()}
    n = int(d["palette_n"])
    return dict(stats=d["rgb_stats"], sat=float(d["average_saturation"]),
                pal_ids=d["palette_ids"][:n].tolist(),
                pal_pct=d["palette_pct"][:n], pal_hsv=d["palette_hsv"][:n],
                sharp=d["sharpness"][:num_boxes], bins=d["blur_bins"],
                angles=d["blur_vector_angles"].tolist(),
                mags=d["blur_vector_mags"].tolist())


def report_fields(rep) -> dict:
    """A Report (what get_report returns), in golden_fields' layout."""
    s = rep.rgb_stats
    return dict(stats=np.array([s.Br, s.Bg, s.Bb, s.Cr, s.Cg, s.Cb]),
                sat=rep.average_saturation,
                pal_ids=list(rep.color_palette.cell_ids),
                pal_pct=np.array(rep.color_palette.quantities),
                pal_hsv=np.array(rep.color_palette.hsv).reshape(-1, 3),
                sharp=np.array(rep.sharpnesses),
                bins=np.array(rep.blur_profile.bins),
                angles=[v.angle for v in rep.blur_vectors],
                mags=[v.magnitude for v in rep.blur_vectors])


def _snr_db(ref, ours) -> float:
    from tests.util import snr_db

    return float(snr_db(ref, ours))


def check_stats(ref: dict, ours: dict):
    """(name, measured, ok, bound) rows for the channel stats and mean
    saturation."""
    snr = _snr_db(ref["stats"], ours["stats"])
    err = abs(ref["sat"] - ours["sat"])
    return [("rgb_stats SNR dB", f"{snr:.1f}", snr > STATS_SNR_DB,
             f"> {STATS_SNR_DB}"),
            ("saturation abs err", f"{err:.2e}", err < SAT_ABS,
             f"< {SAT_ABS}")]


def check_blur(ref: dict, ours: dict):
    """Rows for the polar blur bins and the blur vectors."""
    snr = _snr_db(ref["bins"], ours["bins"])
    bad = sum(a != b for a, b in zip(ref["angles"], ours["angles"]))
    err = max(abs(a - b) for a, b in zip(ref["mags"], ours["mags"]))
    return [("blur_bins SNR dB", f"{snr:.1f}", snr > BINS_SNR_DB,
             f"> {BINS_SNR_DB}"),
            ("blur-vector angle mismatches", bad, bad == 0, "== 0"),
            ("blur-vector mag max abs err", f"{err:.2e}", err < VEC_MAG_ABS,
             f"< {VEC_MAG_ABS}")]


def check_sharpness(ref: dict, ours: dict):
    """Rows for the crop sharpness.  var/mean is unguarded, as in the
    reference: a flat crop gives NaN and a zero response mean inf, on
    both sides alike."""
    rs = np.asarray(ref["sharp"], np.float64)
    os_ = np.asarray(ours["sharp"], np.float64)
    ok = rs.shape == os_.shape and bool(np.all(np.isclose(
        os_, rs, rtol=SHARP_RTOL, atol=0.0, equal_nan=True)))
    fin = np.isfinite(rs) & (rs != 0) if ok else np.zeros(0, bool)
    rel = float(np.max(np.abs(os_[fin] - rs[fin]) / np.abs(rs[fin]))) \
        if fin.any() else 0.0
    return [(f"sharpness max rel err ({rs.size} boxes)", f"{rel:.2e}", ok,
             f"< {SHARP_RTOL}")]


def check_palette(ref: dict, ours: dict):
    """Rows for the palette, compared structurally
    (tests/test_pipeline.py::test_palette_parity): f32 vs f64 HSV moves
    a few boundary pixels between cells."""
    nd = abs(len(ref["pal_ids"]) - len(ours["pal_ids"]))
    rset, oset = set(ref["pal_ids"]), set(ours["pal_ids"])
    common = rset & oset
    jac = len(common) / max(len(rset | oset), 1)
    rpos = {c: k for k, c in enumerate(ref["pal_ids"])}
    opos = {c: k for k, c in enumerate(ours["pal_ids"])}
    pct = hue = sv = 0.0
    for c in common:
        a, b = rpos[c], opos[c]
        pct = max(pct, abs(ref["pal_pct"][a] - ours["pal_pct"][b]))
        dh = abs(ref["pal_hsv"][a][0] - ours["pal_hsv"][b][0])
        hue = max(hue, min(dh, 360.0 - dh))
        sv = max(sv, abs(ref["pal_hsv"][a][1] - ours["pal_hsv"][b][1]),
                 abs(ref["pal_hsv"][a][2] - ours["pal_hsv"][b][2]))
    return [("palette size diff", f"{nd} ({len(ours['pal_ids'])} vs "
             f"{len(ref['pal_ids'])})", nd <= PAL_N_DIFF,
             f"<= {PAL_N_DIFF}"),
            ("palette id jaccard", f"{jac:.3f}", jac > PAL_JACCARD,
             f"> {PAL_JACCARD}"),
            ("palette pct max abs err", f"{pct:.2e}", pct < PAL_PCT_ABS,
             f"< {PAL_PCT_ABS}"),
            ("palette hue max err deg", f"{hue:.3f}", hue < PAL_HUE_DEG,
             f"< {PAL_HUE_DEG}"),
            ("palette s/v max abs err", f"{sv:.2e}", sv < PAL_SV_ABS,
             f"< {PAL_SV_ABS}")]


CHECKS = {"stats": check_stats, "palette": check_palette,
          "sharpness": check_sharpness, "blur": check_blur}


def compare(label: str, ref: dict, ours: dict) -> None:
    """Hold ``ours`` to ``ref`` on every field; print each measured
    error beside its bound, then raise on any miss."""
    misses = []
    for check in CHECKS.values():
        for name, value, ok, bound in check(ref, ours):
            _log(f"  {label}: {name} {value} ({bound})"
                 + ("" if ok else "  <-- MISS"))
            if not ok:
                misses.append(name)
    if misses:
        raise AssertionError(f"{label}: out of bounds: {misses}")


def _same_bits(label: str, first, others) -> None:
    """Raise unless every ReportData in ``others`` equals ``first`` bit
    for bit (the determinism contract: identical inputs, identical
    outputs)."""
    import jax

    ref = [np.asarray(x) for x in jax.device_get(first)]
    bad = sorted({f for o in others for f, a, b in zip(
        first._fields, ref, jax.device_get(o)) if not np.array_equal(a, b)})
    _log(f"{label}: bitwise equal to the first call: {not bad} (== True)")
    if bad:
        raise AssertionError(f"{label}: {bad} differ between calls")


def _timed(fn, *args):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_ingest() -> None:
    """u8_to_unit_f32 on the device == numpy's correctly rounded x/255
    for all 256 byte values, bit for bit."""
    import jax
    import jax.numpy as jnp

    from photohive_dsp_tpu.ops.colorspace import u8_to_unit_f32

    got = np.asarray(jax.jit(u8_to_unit_f32)(
        jnp.arange(256, dtype=jnp.uint8)))
    want = np.arange(256, dtype=np.float32) / np.float32(255.0)
    bad = int(np.sum(got.view(np.uint32) != want.view(np.uint32)))
    _log(f"ingest: {bad} of 256 byte values differ from x/255 bitwise "
         f"(== 0)")
    if bad:
        raise AssertionError(f"ingest: {bad} values not correctly rounded")


def phase_single(h: int, w: int) -> None:
    """get_report on one structured frame with 2 crop boxes."""
    import photohive_dsp_tpu as ph

    u8 = structured_u8(h, w, seed=5)
    blist = two_boxes(h, w)
    rep, dt = _timed(lambda: ph.get_report(u8, box_arrays(blist)))
    keys = len(json.loads(rep.to_json()))
    _log(f"single {h}x{w}: get_report {dt:.1f}s (compile included); "
         f"to_json keys {keys} (== 439)")
    if keys != 439:
        raise AssertionError(f"single: to_json has {keys} keys")
    compare(f"single {h}x{w}", golden_fields(u8, blist), report_fields(rep))


def phase_batched(batch: int, h: int, w: int, card: str = "",
                  steps: int = 5) -> None:
    """BatchRunner.run_u8 on a device-resident batch mixing noise (the
    q=8 palette tier) and structured frames (q=1), 2 boxes each."""
    import jax

    from photohive_dsp_tpu import ReportConfig
    from photohive_dsp_tpu.models.batch import (BatchRunner,
                                                _compiled_u8_batch_fn)

    imgs = np.stack([noise_u8(h, w, i) if i % 2 == 0
                     else structured_u8(h, w, i) for i in range(batch)])
    blist = two_boxes(h, w)
    boxes, valid = box_arrays(blist, batch)
    args = jax.device_put((imgs, boxes, valid))
    runner = BatchRunner(ReportConfig())
    out, setup = _timed(runner.run_u8, *args)
    _log(f"batched {batch}x{h}x{w}: compile + first step {setup:.1f}s "
         f"(set-up)")
    runs = [_timed(runner.run_u8, *args) for _ in range(steps)]
    times = [t for _, t in runs]
    step = sum(times) / len(times)
    _log(f"batched {batch}x{h}x{w}: {steps} warm steps "
         f"{', '.join(f'{t * 1e3:.1f}' for t in times)} ms; "
         f"{batch * h * w / 1e6 / step:.1f} MP/s "
         f"(informational; {card or 'no card info'})")
    _same_bits(f"batched {batch}x{h}x{w}: {steps} warm calls", out,
               [o for o, _ in runs])
    fn, tables = _compiled_u8_batch_fn(h, w, runner.cfg)
    mem = fn.lower(*args, tables).compile().memory_analysis()
    if mem is not None:
        _log(f"batched: memory_analysis argument "
             f"{mem.argument_size_in_bytes / 1e6:.1f} MB, output "
             f"{mem.output_size_in_bytes / 1e6:.1f} MB, temp "
             f"{mem.temp_size_in_bytes / 1e6:.1f} MB")
    stats = jax.devices()[0].memory_stats()
    _log("batched: peak_bytes_in_use "
         + (f"{stats['peak_bytes_in_use'] / 1e9:.2f} GB" if stats
            else "not reported by this backend"))
    # Uniform noise puts dozens of palette cells within a few pixels of
    # the 95% coverage cut, so the boundary pixels that f32 and f64 HSV
    # place in different cells can swap the last parent; the regrouping
    # then moves whole cells.  The CPU backend shows the same difference.
    # So that image's palette is held to the golden quantizer run on
    # float32 HSV planes made in numpy, and its f64 palette comparison is
    # printed for the record only (an open question, PERF.md section 7).
    ref0, ours0 = golden_fields(imgs[0], blist), data_fields(out, 0,
                                                             len(blist))
    for name, value, _, bound in check_palette(ref0, ours0):
        _log(f"  batched noise image 0, palette vs the f64 golden (not "
             f"gated): {name} {value} ({bound})")
    compare("batched noise image 0 (palette vs golden on numpy f32 HSV)",
            dict(ref0, **golden_palette(*f32_hsv(imgs[0]))), ours0)
    compare("batched structured image 1", golden_fields(imgs[1], blist),
            data_fields(out, 1, len(blist)))


def phase_camera(h: int, w: int) -> None:
    """get_report on one camera-sized structured frame with all 10 crop
    boxes, edge boxes and a 3x3 box among them."""
    import photohive_dsp_tpu as ph

    u8 = structured_u8(h, w, seed=12)
    blist = ten_boxes(h, w)
    rep, dt = _timed(lambda: ph.get_report(u8, box_arrays(blist)))
    _log(f"camera {h}x{w}: get_report {dt:.1f}s (compile included), "
         f"{len(rep.sharpnesses)} boxes")
    compare(f"camera {h}x{w}", golden_fields(u8, blist), report_fields(rep))


def phase_corpus(shapes, per_shape: int, batch_size: int) -> None:
    """run_corpus over a mixed-resolution stream: every key comes back
    exactly once, and one image per shape matches BatchRunner.run_u8."""
    import jax

    from photohive_dsp_tpu import ReportConfig
    from photohive_dsp_tpu.models.batch import BatchRunner, run_corpus

    items = []
    for s, (h, w) in enumerate(shapes):
        for j in range(per_shape):
            key = f"{h}x{w}/{j}"
            img = (structured_u8(h, w, 100 * s + j) if j % 2
                   else noise_u8(h, w, 100 * s + j))
            items.append((key, img))
    order = np.random.default_rng(0).permutation(len(items))
    stream = [items[k] for k in order]
    cfg = ReportConfig()
    t0 = time.perf_counter()
    got = {}
    for key, data in run_corpus(iter(stream), cfg, batch_size=batch_size):
        if key in got:
            raise AssertionError(f"corpus: key {key} returned twice")
        got[key] = data
    _log(f"corpus: {len(got)} of {len(items)} keys back exactly once in "
         f"{time.perf_counter() - t0:.1f}s (compiles included)")
    if set(got) != {k for k, _ in items}:
        raise AssertionError("corpus: keys missing")

    runner = BatchRunner(cfg)
    for s, (h, w) in enumerate(shapes):
        # The same images as run_corpus's batch for this shape, in reverse
        # order: the comparison is position- and key-mapping-sensitive.
        keys = [k for k, _ in items if k.startswith(f"{h}x{w}/")]
        keys = keys[:batch_size][::-1]
        ref = jax.device_get(runner.run_u8(
            np.stack([dict(items)[k] for k in keys])))
        ours = got[keys[0]]
        d_ref = {f: np.asarray(v)[0] for f, v in ref._asdict().items()}
        worst = 0.0
        for f, v in ours._asdict().items():
            a, b = np.asarray(v), d_ref[f]
            if a.dtype.kind in "iub":
                if not np.array_equal(a, b):
                    raise AssertionError(f"corpus {h}x{w}: {f} differs")
            else:
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6,
                                           err_msg=f"corpus {h}x{w}: {f}")
                worst = max(worst, float(np.max(np.abs(a - b) / np.maximum(
                    np.abs(b), 1e-30))))
        _log(f"corpus {h}x{w}: {keys[0]} equals run_u8 (ints exact; "
             f"floats max rel diff {worst:.1e}: rtol 1e-5, atol 1e-6)")


def phase_serving(h: int, w: int, batch: int) -> None:
    """export_report + load_report on the device; outputs match
    BatchRunner.run_u8 on the same inputs under the serving contract
    (tests/test_serving.py: an artifact is recompiled on load, so
    last-ulp rounding may move a boundary pixel between palette cells)."""
    import jax

    from photohive_dsp_tpu import ReportConfig
    from photohive_dsp_tpu.models.batch import BatchRunner
    from photohive_dsp_tpu.serving import export_report, load_report

    cfg = ReportConfig()
    imgs = np.stack([structured_u8(h, w, 40 + i) if i % 2
                     else noise_u8(h, w, 40 + i) for i in range(batch)])
    boxes, valid = box_arrays(two_boxes(h, w), batch)
    t0 = time.perf_counter()
    fn = load_report(export_report(h, w, cfg, batch_size=batch))
    out = jax.device_get(jax.block_until_ready(fn(imgs, boxes, valid)))
    _log(f"serving {batch}x{h}x{w}: export + load + first call "
         f"{time.perf_counter() - t0:.1f}s")
    _same_bits("serving: the artifact's second call", out,
               [fn(imgs, boxes, valid)])
    ref = jax.device_get(BatchRunner(cfg).run_u8(imgs, boxes, valid))
    for f in ("palette_n", "blur_vector_angles"):
        if not np.array_equal(np.asarray(getattr(out, f)),
                              np.asarray(getattr(ref, f))):
            raise AssertionError(f"serving: {f} differs")
    pct = 0.0
    for i in range(batch):
        n = int(ref.palette_n[i])
        a = dict(zip(np.asarray(out.palette_ids[i])[:n].tolist(),
                     np.asarray(out.palette_pct[i])[:n]))
        r = dict(zip(np.asarray(ref.palette_ids[i])[:n].tolist(),
                     np.asarray(ref.palette_pct[i])[:n]))
        if set(a) != set(r):
            raise AssertionError(f"serving: image {i} palette ids differ")
        pct = max([pct] + [abs(a[c] - r[c]) for c in r])
    _log(f"serving: palette_n, angles, id sets equal; palette pct max "
         f"abs diff {pct:.1e} (< 5e-4)")
    if pct >= 5e-4:
        raise AssertionError("serving: palette pct out of bounds")
    for f in ("rgb_stats", "average_saturation", "sharpness", "blur_bins",
              "blur_vector_mags"):
        a, b = np.asarray(getattr(out, f)), np.asarray(getattr(ref, f))
        np.testing.assert_allclose(a, b, rtol=3e-6, atol=1e-6,
                                   err_msg=f"serving: {f}")
        _log(f"serving: {f} max abs diff {np.max(np.abs(a - b)):.1e} "
             f"(rtol 3e-6, atol 1e-6)")


def phase_four(devices, batch: int, h: int, w: int, big_h: int, big_w: int,
               spatial_route_mp: float = None,
               check_memory: bool = True) -> None:
    """Four devices: a data=4 mesh on the 32-frame batch, and a
    data=2 x spatial=2 mesh on two camera frames routed to the
    row-sharded body; each result matches the one-device result, the
    outputs are sharded over all four devices, and (on cards) every
    device reports non-zero peak memory."""
    import jax

    from photohive_dsp_tpu import ReportConfig
    from photohive_dsp_tpu.models.batch import SPATIAL_ROUTE_MP, BatchRunner
    from photohive_dsp_tpu.parallel.mesh import make_mesh

    cfg = ReportConfig()
    route_mp = SPATIAL_ROUTE_MP if spatial_route_mp is None \
        else spatial_route_mp
    one = BatchRunner(cfg)
    cases = (
        ("data=4", make_mesh(data=4, devices=devices),
         np.stack([noise_u8(h, w, i) if i % 2 == 0
                   else structured_u8(h, w, i) for i in range(batch)]),
         two_boxes(h, w)),
        ("data=2 x spatial=2",
         make_mesh(data=2, spatial=2, devices=devices),
         np.stack([structured_u8(big_h, big_w, 60 + i) for i in range(2)]),
         ten_boxes(big_h, big_w)))
    for name, mesh, imgs, blist in cases:
        runner = BatchRunner(cfg, mesh=mesh, spatial_route_mp=route_mp)
        nb, ih, iw = imgs.shape[:3]
        spatial = runner.routes_spatially(ih, iw)
        if spatial != (name != "data=4"):
            raise AssertionError(f"four {name}: spatial route {spatial}")
        boxes, valid = box_arrays(blist, nb)
        out, dt = _timed(runner.run_u8, imgs, boxes, valid)
        _log(f"four {name}: {nb}x{ih}x{iw} run_u8 {dt:.1f}s (compile "
             f"included), row-sharded body: {spatial}")
        devs = out.blur_bins.sharding.device_set
        _log(f"four {name}: output on {len(devs)} devices (== 4)")
        if len(devs) != 4:
            raise AssertionError(f"four {name}: output on {len(devs)}")
        ref = jax.device_get(one.run_u8(imgs, boxes, valid))
        out = jax.device_get(out)
        for i in range(nb) if nb <= 2 else (0, 1, nb - 1):
            compare(f"four {name} image {i} vs one device",
                    data_fields(ref, i, len(blist)),
                    data_fields(out, i, len(blist)))
    if check_memory:
        peaks = [d.memory_stats()["peak_bytes_in_use"] for d in devices]
        _log("four: peak_bytes_in_use per device "
             + ", ".join(f"{p / 1e9:.2f} GB" for p in peaks) + " (> 0)")
        if min(peaks) <= 0:
            raise AssertionError("four: a device shows no peak memory")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run the four-card mesh phase only")
    args = ap.parse_args(argv)

    devs = require_gpu()
    need = 4 if args.four else 1
    if len(devs) < need:
        raise SystemExit(f"chip_smoke: {need} GPUs needed, "
                         f"{len(devs)} found")
    card = card_line()
    _log(f"device: {devs[0].device_kind}, using {need} of {len(devs)}; "
         f"nvidia-smi: {card}")
    t0 = time.perf_counter()
    if args.four:
        phase_four(devs[:4], 32, 1080, 1920, 3000, 4000)
    else:
        phase_ingest()
        phase_single(1080, 1920)
        phase_batched(32, 1080, 1920, card)
        phase_camera(3000, 4000)
        phase_corpus(((480, 640), (720, 1280), (1080, 1920)), 32, 32)
        phase_serving(1080, 1920, 8)
    _log(f"all phases passed in {time.perf_counter() - t0:.0f}s on {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": need}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
