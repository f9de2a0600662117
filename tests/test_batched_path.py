"""The batched pipeline must agree with the single-image pipeline: the
batched compositions are pinned against the per-image reference path."""

import numpy as np

import jax
import jax.numpy as jnp

import photohive_dsp_tpu as ph
from photohive_dsp_tpu.models.pipeline import (ReportTables,
                                               full_report_batched,
                                               jitted_full_report)
from photohive_dsp_tpu.models.batch import BatchRunner, run_corpus
from .util import structured_image


def test_batched_matches_single():
    cfg = ph.ReportConfig()
    imgs = np.stack([structured_image(360, 480, seed=i) for i in range(3)])
    boxes = np.zeros((3, 10, 4), np.int32)
    boxes[:, 0] = (40, 200, 60, 300)
    valid = np.zeros((3, 10), bool)
    valid[:, 0] = True

    tables = ReportTables.build(360, 480, cfg)
    batched = jax.jit(
        lambda r, b, v, t: full_report_batched(r, b, v, t, cfg))(
        jnp.asarray(imgs, jnp.float32), jnp.asarray(boxes),
        jnp.asarray(valid), tables)

    fn, tables1 = jitted_full_report(360, 480, cfg)
    for i in range(3):
        single = fn(jnp.asarray(imgs[i], jnp.float32),
                    jnp.asarray(boxes[i]), jnp.asarray(valid[i]), tables1)
        one = jax.tree.map(lambda x, i=i: x[i], batched)
        np.testing.assert_allclose(np.asarray(one.rgb_stats),
                                   np.asarray(single.rgb_stats), rtol=1e-6)
        assert int(one.palette_n) == int(single.palette_n)
        np.testing.assert_array_equal(np.asarray(one.palette_ids),
                                      np.asarray(single.palette_ids))
        np.testing.assert_allclose(np.asarray(one.palette_hsv),
                                   np.asarray(single.palette_hsv),
                                   atol=2e-3)
        np.testing.assert_allclose(np.asarray(one.blur_bins),
                                   np.asarray(single.blur_bins), atol=1e-5)
        np.testing.assert_array_equal(np.asarray(one.blur_vector_angles),
                                      np.asarray(single.blur_vector_angles))
        np.testing.assert_allclose(np.asarray(one.sharpness),
                                   np.asarray(single.sharpness), rtol=1e-4)


def test_u8_entry_matches_f32():
    # structured (well-separated palette) images: XLA may compile the u8
    # path's /255 as a reciprocal multiply, so near-tie saliency orders on
    # pure random data can legitimately differ by ulps.
    cfg = ph.ReportConfig()
    u8 = np.stack([
        np.moveaxis((structured_image(360, 480, seed=i) * 255).round(), 0, -1)
        for i in range(2)
    ]).astype(np.uint8)
    runner = BatchRunner(cfg)
    out_u8 = runner.run_u8(u8)
    f32 = np.moveaxis(u8, -1, 1).astype(np.float32) / 255.0
    out_f32 = runner.run(f32)
    np.testing.assert_allclose(np.asarray(out_u8.rgb_stats),
                               np.asarray(out_f32.rgb_stats), atol=1e-6)
    # the /255 normalization may compile as a reciprocal multiply in one
    # path, shifting boundary pixels by an ulp: palette id SETS must agree
    # and percentages must match per id, but near-tie adjacent order may
    # legitimately swap.
    for i in range(u8.shape[0]):
        n8 = int(out_u8.palette_n[i])
        n32 = int(out_f32.palette_n[i])
        assert abs(n8 - n32) <= 1
        ids8 = set(np.asarray(out_u8.palette_ids[i])[:n8].tolist())
        ids32 = set(np.asarray(out_f32.palette_ids[i])[:n32].tolist())
        common = ids8 & ids32
        assert len(common) / max(len(ids8 | ids32), 1) > 0.95
        pct8 = dict(zip(np.asarray(out_u8.palette_ids[i])[:n8].tolist(),
                        np.asarray(out_u8.palette_pct[i])[:n8]))
        pct32 = dict(zip(np.asarray(out_f32.palette_ids[i])[:n32].tolist(),
                         np.asarray(out_f32.palette_pct[i])[:n32]))
        for cid in common:
            assert abs(pct8[cid] - pct32[cid]) < 1e-3


def test_run_corpus_mixed_shapes():
    cfg = ph.ReportConfig()
    items = [(f"k{i}", structured_image(360, 480, seed=i)) for i in range(3)]
    items += [(f"m{i}", structured_image(352, 400, seed=i)) for i in range(2)]
    got = dict(run_corpus(iter(items), cfg, batch_size=2))
    assert set(got) == {"k0", "k1", "k2", "m0", "m1"}
    for key, data in got.items():
        assert np.isfinite(np.asarray(data.rgb_stats)).all()
        assert 0 < int(data.palette_n) <= cfg.num_cells


def test_run_corpus_routes_large_images_spatially():
    """Size-based routing (SURVEY §7.4): on a mesh with a spatial axis,
    images at or above the MP threshold run through the row-sharded dp x
    spatial body — here at a non-dividing height (242 rows over 4 shards,
    zero-row-padded and masked) — while small images keep the replicated
    data-parallel path.  Both must match the single-device report."""
    from photohive_dsp_tpu.parallel import mesh as meshlib
    from .util import snr_db

    cfg = ph.ReportConfig()
    m = meshlib.make_mesh(data=2, spatial=4)
    probe = BatchRunner(cfg, mesh=m, spatial_route_mp=0.05)
    assert probe.routes_spatially(242, 320)        # 0.077 MP >= 0.05
    assert not probe.routes_spatially(96, 128)     # 0.012 MP

    big = [(f"b{i}", structured_image(242, 320, seed=10 + i))
           for i in range(2)]
    small = [(f"s{i}", structured_image(96, 128, seed=20 + i))
             for i in range(2)]
    got = dict(run_corpus(iter(big + small), cfg, mesh=m, batch_size=2,
                          spatial_route_mp=0.05))
    assert set(got) == {"b0", "b1", "s0", "s1"}
    zb = jnp.zeros((10, 4), jnp.int32)
    zv = jnp.zeros((10,), bool)
    for key, img in big + small:
        h, w = img.shape[1], img.shape[2]
        fn, tables = jitted_full_report(h, w, cfg)
        ref = fn(jnp.asarray(img, jnp.float32), zb, zv, tables)
        ours = got[key]
        np.testing.assert_allclose(np.asarray(ours.rgb_stats),
                                   np.asarray(ref.rgb_stats),
                                   rtol=2e-5, atol=1e-6)
        assert int(ours.palette_n) == int(ref.palette_n)
        n = int(ref.palette_n)
        np.testing.assert_array_equal(np.asarray(ours.palette_ids)[:n],
                                      np.asarray(ref.palette_ids)[:n])
        np.testing.assert_allclose(np.asarray(ours.palette_pct)[:n],
                                   np.asarray(ref.palette_pct)[:n],
                                   atol=1e-6)
        assert snr_db(np.asarray(ref.blur_bins),
                      np.asarray(ours.blur_bins)) > 55


def test_warmup_precompiles_and_matches():
    """warmup() AOT-compiles each shape; a following run_u8 returns the
    same reports as an un-warmed runner."""
    from photohive_dsp_tpu.models.batch import BatchRunner, warmup

    cfg = ph.ReportConfig()
    n = warmup([(360, 480)], cfg, batch_size=4)
    assert n == 1
    rng = np.random.default_rng(11)
    imgs = rng.integers(0, 256, (4, 360, 480, 3), dtype=np.uint8)
    out = BatchRunner(cfg).run_u8(imgs)
    assert np.isfinite(np.asarray(out.rgb_stats)).all()

    from photohive_dsp_tpu.parallel.mesh import make_mesh
    mesh = make_mesh(data=jax.device_count() // 2, spatial=2)
    n = warmup([(360, 480), (4000, 4000)], cfg, mesh=mesh, batch_size=4)
    assert n == 1  # the 16 MP shape routes spatially -> skipped


def test_run_stream_u8_prefetch_matches():
    """Opt-in device_put prefetch changes timing only, not results."""
    cfg = ph.ReportConfig()
    runner = BatchRunner(cfg)
    rng = np.random.default_rng(12)
    batches = []
    for _ in range(3):
        imgs = rng.integers(0, 256, (2, 360, 480, 3), dtype=np.uint8)
        boxes = np.zeros((2, 10, 4), np.int32)
        valid = np.zeros((2, 10), bool)
        batches.append((imgs, boxes, valid))
    seq = [jax.device_get(o) for o in runner.run_stream_u8(iter(batches))]
    pre = [jax.device_get(o) for o in runner.run_stream_u8(iter(batches),
                                                           prefetch=2)]
    for a, b in zip(seq, pre):
        for la, lb in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            la, lb = np.asarray(la), np.asarray(lb)
            if la.dtype.kind in "iub":
                np.testing.assert_array_equal(la, lb)
            else:
                # Bitwise equality holds in isolation, but when an earlier
                # test has run corpus work on a virtual-device mesh, XLA
                # can recompile the prefetch-thread dispatch with a
                # different fusion arrangement and blur_bins wobbles by
                # ~1 ulp (observed 1.2e-7 on 0.7-magnitude values; order-
                # dependent, pre-dates the rgb-native kernels).  Results
                # are still equal to float32 resolution, which is the
                # property this test guards.
                np.testing.assert_allclose(la, lb, rtol=3e-7, atol=3e-7)


def test_run_f32_spatial_route_pads_to_data_axis():
    """BatchRunner.run() (float entry) routes large images spatially and
    pads only to the 2-D mesh's data axis (not the flat all-devices
    axis); results match the single-device report."""
    from photohive_dsp_tpu.parallel import mesh as meshlib

    cfg = ph.ReportConfig()
    m = meshlib.make_mesh(data=2, spatial=4)
    runner = BatchRunner(cfg, mesh=m, spatial_route_mp=0.05)
    img = structured_image(242, 320, seed=33)     # 0.077 MP >= 0.05
    assert runner.routes_spatially(242, 320)
    out = runner.run(np.asarray(img, np.float32)[None])   # b=1 -> pad to 2

    fn, tables = jitted_full_report(242, 320, cfg)
    ref = fn(jnp.asarray(img, jnp.float32), jnp.zeros((10, 4), jnp.int32),
             jnp.zeros((10,), bool), tables)
    assert out.rgb_stats.shape[0] == 1            # padding dropped
    np.testing.assert_allclose(np.asarray(out.rgb_stats)[0],
                               np.asarray(ref.rgb_stats),
                               rtol=2e-5, atol=1e-6)
    assert int(out.palette_n[0]) == int(ref.palette_n)
    n = int(ref.palette_n)
    np.testing.assert_array_equal(np.asarray(out.palette_ids)[0][:n],
                                  np.asarray(ref.palette_ids)[:n])
