"""Per-stage timing and profiling.

The reference wraps every pipeline stage in printf wall-clock timers
(START_TIMING/END_TIMING, src/utilities.h:10-18, used throughout
src/interface.c:38-92).  The equivalents here:

  * ``stage_timings``: compiles each pipeline stage separately and times it
    on-device (warm), reproducing the reference's per-stage transcript
    (README.md:63-75) for our build.  Separately compiled stages pay a
    dispatch each and lose the fusion across stage boundaries, so the
    "full report (fused)" row (one executable) is the truthful total;
  * ``trace``: context manager around ``jax.profiler`` emitting a
    TensorBoard-loadable trace of the fused pipeline.

Inside the fused jit program the stages carry ``jax.named_scope`` labels via
their op structure, so profiler traces attribute time per stage.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import numpy as np


def _time(fn, *args, iters=5):
    import jax

    f = jax.jit(fn)
    out = jax.block_until_ready(f(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = jax.block_until_ready(f(*args))
    return (time.perf_counter() - t0) / iters, out


def stage_timings(height: int = 1080, width: int = 1920, batch: int = 16,
                  cfg=None, seed: int = 0) -> Dict[str, float]:
    """Per-stage wall-clock seconds (warm, on the default backend).

    Stage names mirror the reference's transcript labels (README.md:63-75).
    """
    import jax
    import jax.numpy as jnp

    from ..config import ReportConfig
    from ..models.pipeline import ReportTables, full_report_batched
    from ..ops import colorspace, fft, sharpness, stats
    from ..ops.blur import blur_profile_bins_batched, vectorize_blur_profile
    from ..ops.quantize import color_palette_batched

    cfg = cfg or ReportConfig()
    tables = ReportTables.build(height, width, cfg)
    rng = np.random.default_rng(seed)
    rgb = jnp.asarray(rng.random((batch, 3, height, width)), jnp.float32)
    boxes = jnp.zeros((batch, 10, 4), jnp.int32).at[:, 0].set(
        jnp.asarray([height // 8, height // 2, width // 8, width // 2],
                    jnp.int32))
    valid = jnp.zeros((batch, 10), bool).at[:, 0].set(True)

    out: Dict[str, float] = {}
    t, hsv = _time(
        lambda r: jax.vmap(lambda x: colorspace.rgb_to_hsv(x[0], x[1],
                                                           x[2]))(r), rgb)
    out["rgb2hsv"] = t
    t, pgm = _time(
        lambda r: jax.vmap(lambda x: colorspace.rgb_to_pgm(x[0], x[1],
                                                           x[2]))(r), rgb)
    out["rgb2pgm"] = t
    out["rgb statistics"], st = _time(
        lambda r: jax.vmap(lambda x: stats.rgb_statistics(x[0], x[1],
                                                          x[2]))(r), rgb)
    out["hsv average"], _ = _time(
        lambda s: jax.vmap(stats.mean_saturation)(s), hsv[1])
    out["color palette"], _ = _time(
        lambda a, b, c: color_palette_batched(a, b, c, cfg, tables.octree),
        *hsv)
    out["sharpness"], _ = _time(
        lambda p, b, v: jax.vmap(sharpness.variance_sharpness)(p, b, v),
        pgm, boxes, valid)
    dc = (st[:, 0] + st[:, 1] + st[:, 2]) / 3.0
    out["magnitude fft"], mag = _time(
        lambda p: jax.vmap(fft.magnitude_fft_normalized)(p),
        pgm - dc[:, None, None])
    out["blur profile bins"], bins = _time(
        lambda m: blur_profile_bins_batched(m, tables.polar,
                                            cfg.angle_partitions,
                                            cfg.radius_partitions), mag)
    out["blur vectors"], _ = _time(
        lambda b: jax.vmap(lambda x: vectorize_blur_profile(x, cfg))(b),
        bins)
    out["full report (fused)"], _ = _time(
        lambda r, b, v: full_report_batched(r, b, v, tables, cfg),
        rgb, boxes, valid)
    return out


def print_stage_timings(height: int = 1080, width: int = 1920,
                        batch: int = 16, cfg=None) -> None:
    """Reference-transcript-style printout (cf. reference README.md:62-75)."""
    timings = stage_timings(height, width, batch, cfg)
    mp = batch * height * width / 1e6
    print(f"per-stage timings, batch of {batch} {width}x{height} "
          f"({mp:.0f} MP):")
    for name, t in timings.items():
        print(f"  {name} took {t:.6f} seconds to execute")
    full = timings["full report (fused)"]
    print(f"  => fused throughput {mp / full:.1f} MP/s")
    print("  (per-stage numbers run as separate executables, each with its "
          "own dispatch\n   and no fusion across stages; for stage costs "
          "inside the fused program\n   read a profiler trace)")


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace around a block (open with TensorBoard/XProf)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


if __name__ == "__main__":
    import sys

    args = [int(a) for a in sys.argv[1:4]]
    print_stage_timings(*args)
