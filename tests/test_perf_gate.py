"""Perf regression gate (CI, CPU-stable).

The reference's analogue is the <0.5 s full-report latency gate in its C
test suite (src/test/test.c:152).  Wall-clock on shared CI is noisy, so the
primary pin here is the *compiled cost analysis* of the fused batched
program — deterministic for a given jax version, and sensitive to the
regressions that actually halved throughput during development:

  * a contraction taking a multi-pass precision path it does not need
    (~+35% flops);
  * a stage getting computed twice (e.g. a lost CSE across the
    sharpness/blur shared Laplacian) (~+20-60% flops or bytes);
  * an elementwise stage de-fusing into extra materialized passes
    (+bytes).

Measured on the CPU at 2 x 360x480: ~2738 flops/px, ~2299 bytes/px, ~0.50
transcendentals/px.  Bounds carry ~25% headroom; if a *deliberate*
algorithm change moves the cost, update the bounds in the same commit.

A generous warm wall-clock ceiling backs this up for non-flop regressions
(accidental device sync per stage, scan-ification of a fused loop).
"""

from __future__ import annotations

import functools
import time

import jax
import jax.numpy as jnp

from photohive_dsp_tpu import ReportConfig
from photohive_dsp_tpu.models.pipeline import ReportTables, full_report_batched

B, H, W = 2, 360, 480

FLOPS_PER_PX_MAX = 3400.0
BYTES_PER_PX_MAX = 2900.0
TRANSCENDENTALS_PER_PX_MAX = 0.65
WARM_ITER_MAX_S = 3.0  # typical ~0.1-0.3 s; only disasters trip this


def _compiled():
    cfg = ReportConfig()
    tables = ReportTables.build(H, W, cfg)
    fn = jax.jit(functools.partial(full_report_batched, cfg=cfg))
    rgb = jnp.zeros((B, 3, H, W), jnp.float32)
    boxes = jnp.zeros((B, 10, 4), jnp.int32)
    valid = jnp.zeros((B, 10), bool)
    return fn, (rgb, boxes, valid, tables)


def test_compiled_cost_within_bounds():
    fn, args = _compiled()
    ca = fn.lower(*args).compile().cost_analysis()
    ca = ca[0] if isinstance(ca, list) else ca
    px = B * H * W
    assert ca["flops"] / px < FLOPS_PER_PX_MAX, ca["flops"] / px
    assert ca["bytes accessed"] / px < BYTES_PER_PX_MAX, \
        ca["bytes accessed"] / px
    assert ca["transcendentals"] / px < TRANSCENDENTALS_PER_PX_MAX, \
        ca["transcendentals"] / px


def test_warm_latency_ceiling():
    fn, args = _compiled()
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(3):
        out = fn(*args)
        jax.block_until_ready(out)
    per_iter = (time.perf_counter() - t0) / 3
    assert per_iter < WARM_ITER_MAX_S, f"warm iter {per_iter:.2f}s"


def test_dp_spatial_collective_census():
    """Pin the collective count of the compiled dp-spatial executable.

    The spatial axis legitimately needs collectives (psum reductions,
    1-row ppermute halos, the all_to_all FFT transpose, pmax for the
    spectrum norm); the data axis needs ZERO.  A regression that, e.g.,
    un-hoists a reduction into the per-image vmap or adds a reshard
    would show up here as a count jump long before it is measurable on
    hardware.  Measured at this pin: 28 collectives (XLA path, 2x2 mesh,
    batch 4 at 128x96: 20 all-reduce, 4 all-to-all, 4 collective-permute,
    0 all-gather/reduce-scatter).  Bound carries headroom for
    jax-version drift; a deliberate comm change must update it in the
    same commit."""
    from photohive_dsp_tpu.parallel import mesh as meshlib
    from photohive_dsp_tpu.parallel.spatial import build_dp_spatial_report

    m = meshlib.make_mesh(data=2, spatial=2, devices=jax.devices()[:4])
    cfg = ReportConfig()
    fn = build_dp_spatial_report(m, 4, 128, 96, cfg)
    rgb = jnp.zeros((4, 3, 128, 96), jnp.float32)
    boxes = jnp.zeros((4, 10, 4), jnp.int32)
    valid = jnp.zeros((4, 10), bool)
    hlo = fn.lower(rgb, boxes, valid).compile().as_text()
    colls = ("all-reduce", "all-gather", "all-to-all",
             "collective-permute", "reduce-scatter")
    counts = {c: hlo.count(c) for c in colls}
    total = sum(counts.values())
    assert total <= 34, (total, counts)
