"""Benchmark: full-report throughput in megapixels/s.

Runs in one process on the default JAX backend and prints exactly ONE JSON
line on stdout; progress goes to stderr.  It needs a GPU: with no GPU it
exits non-zero, unless JAX_PLATFORMS=cpu was set explicitly, which runs a
small rehearsal (batch 4) whose numbers describe XLA:CPU, not the card.
Every line names the device it ran on (platform, device_kind, count).

Cells (uint8 frames resident on the device, 2 crop boxes per image):
  * value / synced_mps: 1080p uniform noise at batch 32 (the q=8 palette
    tier), pipelined dispatch with one final sync / synced every step;
  * structured_1080p_mps: photo-like content (the q=1 tier);
  * marginal_mps, marginal_structured_mps: the batch-slope rate between
    batch 32 and 16;
  * blur_4k_ms: the 2160x3840 blur-profile chain per image;
  * mixed_res_device_mps: per-bucket batch-slope rates (480p/720p/1080p)
    combined as an equal-image-count corpus;
  * mixed_res_mps: the same mix end to end through run_corpus.

vs_baseline is against the reference C library's published per-stage
timings (~1.73 s per 1080p image on a 12-core CPU => ~1.19 MP/s;
reference README.md:63-75, BASELINE.md).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

REFERENCE_MPS = 2.0736 / 1.73  # 1920x1080 MP / published total seconds
HEIGHT, WIDTH = 1080, 1920


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _boxes(batch: int):
    boxes = np.zeros((batch, 10, 4), np.int32)
    boxes[:, 0] = (100, 500, 200, 900)
    boxes[:, 1] = (400, 900, 600, 1500)
    valid = np.zeros((batch, 10), bool)
    valid[:, :2] = True
    return boxes, valid


def _photo(h: int, w: int, seed: int = 7) -> np.ndarray:
    """Photo-like (H, W, 3) uint8: gradients, saturated blobs, mild noise
    (the test suite's structured_image recipe) — the q=1 palette tier."""
    yg, xg = np.mgrid[0:h, 0:w].astype(np.float32)
    r = 0.25 + 0.5 * (xg / w)
    g = 0.25 + 0.5 * (yg / h)
    b = 0.35 + 0.25 * np.sin(2 * np.pi * xg / 97) * np.cos(2 * np.pi * yg / 61)
    for cy, cx, rad, col in ((h * 0.3, w * 0.3, 160, (0.9, 0.1, 0.1)),
                             (h * 0.7, w * 0.6, 220, (0.1, 0.8, 0.2)),
                             (h * 0.4, w * 0.8, 140, (0.15, 0.2, 0.9))):
        m = (yg - cy) ** 2 + (xg - cx) ** 2 < rad ** 2
        r[m], g[m], b[m] = col
    img = np.stack([r, g, b], -1)
    img += np.random.default_rng(seed).normal(0, 0.01, img.shape)
    return (np.clip(img, 0.0, 1.0) * 255.0).round().astype(np.uint8)


def _best_of(fn, args, n: int) -> float:
    import jax

    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def _u8_fn(cfg, h: int, w: int):
    """A fresh jit of the batched uint8 report program (one per batch
    size, so two batch sizes never share an executable cache slot)."""
    import jax
    import jax.numpy as jnp

    from photohive_dsp_tpu.models.pipeline import (ReportTables,
                                                   full_report_batched)
    from photohive_dsp_tpu.ops.colorspace import u8_to_unit_f32

    tables = ReportTables.build(h, w, cfg)

    @jax.jit
    def fn(u8, boxes, valid):
        rgb = u8_to_unit_f32(jnp.moveaxis(u8, -1, 1))
        return full_report_batched(rgb, boxes, valid, tables, cfg)

    return fn


def measure_1080p(cfg, batch: int) -> dict:
    import jax

    rng = np.random.default_rng(0)
    frames = [jax.device_put(rng.integers(0, 256, (batch, HEIGHT, WIDTH, 3),
                                          dtype=np.uint8)) for _ in range(2)]
    boxes, valid = (jax.device_put(a) for a in _boxes(batch))
    fn = _u8_fn(cfg, HEIGHT, WIDTH)
    t0 = time.perf_counter()
    jax.block_until_ready(fn(frames[0], boxes, valid))
    _log(f"1080p compile+first step {time.perf_counter() - t0:.1f}s")

    iters = 8
    t0 = time.perf_counter()
    outs = [fn(frames[i % 2], boxes, valid) for i in range(iters)]
    jax.block_until_ready(outs)
    dt = time.perf_counter() - t0
    mp = batch * HEIGHT * WIDTH / 1e6
    synced = _best_of(fn, (frames[1], boxes, valid), 4)

    photo = jax.device_put(np.broadcast_to(
        _photo(HEIGHT, WIDTH), (batch, HEIGHT, WIDTH, 3)).copy())
    jax.block_until_ready(fn(photo, boxes, valid))
    t0 = time.perf_counter()
    jax.block_until_ready([fn(photo, boxes, valid) for _ in range(iters)])
    s_dt = time.perf_counter() - t0

    res = {"value": mps(mp * iters / dt), "synced_mps": mps(mp / synced),
           "structured_1080p_mps": mps(mp * iters / s_dt)}
    half = batch // 2
    fnh = _u8_fn(cfg, HEIGHT, WIDTH)
    for key, fr in (("marginal_mps", frames[1]),
                    ("marginal_structured_mps", photo)):
        args_h = (fr[:half], boxes[:half], valid[:half])
        jax.block_until_ready(fnh(*args_h))
        t_full = _best_of(fn, (fr, boxes, valid), 6)
        t_half = _best_of(fnh, args_h, 6)
        if t_full > t_half:
            res[key] = mps((batch - half) * HEIGHT * WIDTH / 1e6
                           / (t_full - t_half))
    return res


def measure_blur_4k(cfg, batch: int) -> dict:
    """Blur-profile chain (DC removal -> rfft2 magnitude -> log normalize
    -> polar bins) on 2160x3840 grayscale frames."""
    import jax
    import jax.numpy as jnp

    from photohive_dsp_tpu.ops.blur import (PolarTables,
                                            blur_profile_bins_batched)
    from photohive_dsp_tpu.ops.fft import magnitude_fft_normalized

    h4, w4 = 2160, 3840
    tables = PolarTables.for_shape(h4, w4, cfg)

    @jax.jit
    def chain(pgm):
        dc = jnp.mean(pgm, axis=(1, 2), keepdims=True)
        mag = jax.vmap(magnitude_fft_normalized)(pgm - dc)
        return blur_profile_bins_batched(mag, tables, cfg.angle_partitions,
                                         cfg.radius_partitions)

    rng = np.random.default_rng(1)
    frames = [jax.device_put(rng.random((batch, h4, w4), np.float32))
              for _ in range(2)]
    jax.block_until_ready(chain(frames[0]))
    iters = 6
    t0 = time.perf_counter()
    jax.block_until_ready([chain(frames[i % 2]) for i in range(iters)])
    ms = (time.perf_counter() - t0) / (iters * batch) * 1e3
    return {"blur_4k_ms": ms}


MIXED_SHAPES = ((480, 640), (720, 1280), (1080, 1920))


def measure_mixed_res_device(cfg, full_small: int, full_large: int) -> dict:
    """Per-bucket batch-slope rates on device-resident frames, combined
    as the time-weighted throughput of an equal-image-count corpus."""
    import jax

    rng = np.random.default_rng(5)
    per_bucket, t_per_img, mp_per_img = {}, 0.0, 0.0
    for h, w in MIXED_SHAPES:
        full = full_large if h * w > 1.5e6 else full_small
        half = full // 2
        boxes, valid = (jax.device_put(a) for a in _boxes(full))
        frame = jax.device_put(rng.integers(0, 256, (full, h, w, 3),
                                            dtype=np.uint8))
        fn, fnh = _u8_fn(cfg, h, w), _u8_fn(cfg, h, w)
        args, args_h = (frame, boxes, valid), (frame[:half], boxes[:half],
                                               valid[:half])
        jax.block_until_ready((fn(*args), fnh(*args_h)))
        t_full, t_half = _best_of(fn, args, 6), _best_of(fnh, args_h, 6)
        if t_full <= t_half:
            _log(f"{h}x{w}: slope not resolvable")
            continue
        per_bucket[f"{h}x{w}"] = mps((full - half) * h * w / 1e6
                                     / (t_full - t_half))
        t_per_img += (t_full - t_half) / (full - half)
        mp_per_img += h * w / 1e6
    if not per_bucket:
        return {}
    return {"mixed_res_device_mps": mps(mp_per_img / t_per_img),
            "mixed_res_device_buckets": per_bucket}


def measure_mixed_res(cfg, n: int) -> dict:
    """The same mix end to end through run_corpus (host arrays in,
    host reports out)."""
    from photohive_dsp_tpu.models.batch import run_corpus

    rng = np.random.default_rng(3)
    imgs = []
    for i in range(n):
        h, w = MIXED_SHAPES[i % len(MIXED_SHAPES)]
        imgs.append((i, rng.integers(0, 256, (h, w, 3), np.uint8)))
    total_mp = sum(im.shape[0] * im.shape[1] for _, im in imgs) / 1e6
    sum(1 for _ in run_corpus(iter(imgs[:3 * 16]), cfg, batch_size=16))
    t0 = time.perf_counter()
    done = sum(1 for _ in run_corpus(iter(imgs), cfg, batch_size=16))
    dt = time.perf_counter() - t0
    assert done == n
    return {"mixed_res_mps": mps(total_mp / dt), "mixed_res_images": n}


def mps(x: float) -> float:
    return round(float(x), 3)


def main() -> int:
    import jax

    from photohive_dsp_tpu import ReportConfig

    dev = jax.devices()[0]
    rehearsal = os.environ.get("JAX_PLATFORMS") == "cpu"
    if dev.platform != "gpu" and not rehearsal:
        _log(f"no GPU found (platform {dev.platform!r}); set "
             "JAX_PLATFORMS=cpu explicitly for a small CPU rehearsal")
        return 1
    cfg = ReportConfig()
    batch = 4 if rehearsal else 32
    result = {"metric": "full_report_throughput_1080p", "unit": "MP/s",
              "platform": dev.platform, "device_kind": dev.device_kind,
              "device_count": len(jax.devices()), "batch": batch}
    result.update(measure_1080p(cfg, batch))
    result["vs_baseline"] = round(result["value"] / REFERENCE_MPS, 2)
    result.update(measure_blur_4k(cfg, 1 if rehearsal else 4))
    result.update(measure_mixed_res_device(cfg, *((4, 4) if rehearsal
                                                  else (32, 16))))
    result.update(measure_mixed_res(cfg, 48 if rehearsal else 256))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
