"""AOT serving-export artifact: serialize -> rehydrate -> exact parity.

The serialized StableHLO module must reproduce the live pipeline's
report bit-for-bit on the same backend (it is the same program, with
tables embedded as constants)."""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import photohive_dsp_tpu as ph
from photohive_dsp_tpu.models.pipeline import ReportTables, \
    full_report_batched
from photohive_dsp_tpu.serving import export_report, load_report

from .util import structured_image

CFG = ph.ReportConfig()


def test_export_roundtrip_exact_parity(tmp_path):
    imgs = np.stack([structured_image(360, 480, seed=s) for s in (1, 4)])
    u8 = np.moveaxis((imgs * 255).astype(np.uint8), 1, -1)
    boxes, valid = ph.set_bounding_boxes([
        dict(top=20, bottom=200, left=30, right=300)])
    bb = np.broadcast_to(boxes, (2, 10, 4)).copy()
    bv = np.broadcast_to(valid, (2, 10)).copy()

    blob = export_report(360, 480, CFG, batch_size=2)
    # survives a file round trip (the deployable artifact)
    p = tmp_path / "report_360x480.jaxexport"
    p.write_bytes(blob)
    fn = load_report(p.read_bytes())
    out = fn(u8, bb, bv)

    tables = ReportTables.build(360, 480, CFG)
    rgb = jnp.moveaxis(jnp.asarray(u8), -1, 1).astype(jnp.float32) / 255.0
    ref = jax.jit(
        lambda r, b, v: full_report_batched(r, b, v, tables, CFG)
    )(rgb, jnp.asarray(bb), jnp.asarray(bv))

    # The artifact is recompiled by the local XLA on load, so fusion /
    # FMA-contraction choices (hence f32 rounding at the last ulp) may
    # differ from the live jit.  That can hop pixels sitting exactly on
    # an HSV cell boundary to the neighboring cell, nudging counts by
    # ~1e-4 of the image and swapping near-tied saliency pairs — the
    # same class of drift a jax/XLA upgrade causes for the live path.
    # The artifact itself is deterministic (same bytes -> same outputs).
    # Contract: same palette SET with per-id percentages tight; dense
    # fields ulp-tight; exact equality is pinned for ints that don't sit
    # on a continuum (n, angles).
    np.testing.assert_array_equal(np.asarray(out.palette_n),
                                  np.asarray(ref.palette_n))
    np.testing.assert_array_equal(np.asarray(out.blur_vector_angles),
                                  np.asarray(ref.blur_vector_angles))
    for i in range(2):
        n = int(ref.palette_n[i])
        a_ids = np.asarray(out.palette_ids[i])[:n]
        r_ids = np.asarray(ref.palette_ids[i])[:n]
        assert set(a_ids) == set(r_ids)
        a_pct = dict(zip(a_ids, np.asarray(out.palette_pct[i])[:n]))
        r_pct = dict(zip(r_ids, np.asarray(ref.palette_pct[i])[:n]))
        for cid in r_pct:
            assert abs(a_pct[cid] - r_pct[cid]) < 5e-4, cid
    for name in ("rgb_stats", "average_saturation", "sharpness",
                 "blur_bins", "blur_vector_mags"):
        np.testing.assert_allclose(
            np.asarray(getattr(out, name)), np.asarray(getattr(ref, name)),
            rtol=3e-6, atol=1e-6, err_msg=name)


def test_export_rejects_invalid_config():
    import pytest

    with pytest.raises(ValueError):
        export_report(360, 480, ph.ReportConfig(h_partitions=7))


def test_export_dynamic_batch():
    """batch_size="dynamic" exports a symbolic-batch artifact that
    serves any batch size from one blob."""
    imgs2 = np.stack([(structured_image(360, 480, seed=s) * 255)
                      for s in (1, 4)]).astype(np.uint8)
    u8_2 = np.moveaxis(imgs2, 1, -1)
    u8_3 = np.concatenate([u8_2, u8_2[:1]])
    blob = export_report(360, 480, CFG, batch_size="dynamic")
    fn = load_report(blob)
    for u8 in (u8_2, u8_3):
        b = u8.shape[0]
        out = fn(u8, np.zeros((b, 10, 4), np.int32),
                 np.zeros((b, 10), bool))
        assert np.asarray(out.palette_n).shape == (b,)
        assert np.isfinite(np.asarray(out.rgb_stats)).all()
    # the two batch sizes agree on the shared images
    o2 = fn(u8_2, np.zeros((2, 10, 4), np.int32), np.zeros((2, 10), bool))
    o3 = fn(u8_3, np.zeros((3, 10, 4), np.int32), np.zeros((3, 10), bool))
    np.testing.assert_array_equal(np.asarray(o2.palette_n),
                                  np.asarray(o3.palette_n)[:2])


def test_export_mesh_dp_artifact():
    """mesh= exports the data-parallel program; load_report(mesh=...)
    shards inputs and runs it on the same device count, matching the
    single-device artifact's results."""
    from photohive_dsp_tpu.parallel.mesh import make_mesh

    imgs = np.stack([(structured_image(360, 480, seed=s) * 255)
                     for s in (1, 4)]).astype(np.uint8)
    u8 = np.moveaxis(imgs, 1, -1)
    u8_8 = np.concatenate([u8] * 4)
    bx = np.zeros((8, 10, 4), np.int32)
    vl = np.zeros((8, 10), bool)
    mesh = make_mesh(data=8, spatial=1)
    blob = export_report(360, 480, CFG, batch_size=8, mesh=mesh)
    fn = load_report(blob, mesh=make_mesh(data=8, spatial=1))
    out = fn(u8_8, bx, vl)
    ref_blob = export_report(360, 480, CFG, batch_size=2)
    ref = load_report(ref_blob)(u8, bx[:2], vl[:2])
    np.testing.assert_array_equal(np.asarray(out.palette_n)[:2],
                                  np.asarray(ref.palette_n))
    np.testing.assert_array_equal(np.asarray(out.palette_ids)[:2],
                                  np.asarray(ref.palette_ids))


def test_artifact_round_trip_without_flatbuffers():
    """Export and load work where the flatbuffers package (which jax's
    own Exported.serialize needs) is missing, as on GPU serving hosts."""
    import os
    import subprocess
    import sys

    code = """
import sys
sys.modules["flatbuffers"] = None   # any import of it now fails
import numpy as np
from photohive_dsp_tpu.serving import export_report, load_report
fn = load_report(export_report(360, 480, batch_size=1))
out = fn(np.zeros((1, 360, 480, 3), np.uint8), np.zeros((1, 10, 4), np.int32),
         np.zeros((1, 10), bool))
assert np.isfinite(np.asarray(out.rgb_stats)).all()
print("ok")
"""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


@pytest.mark.parametrize("blob", [
    b"not an artifact",
    # this module's container, written by another jax version
    b"photohive-report-export 1\n" + json.dumps(
        {"jax_version": "0.0.0"}).encode() + b"\n",
], ids=["foreign", "other_jax"])
def test_load_rejects_foreign_bytes(blob):
    with pytest.raises(ValueError, match="export_report"):
        load_report(blob)
