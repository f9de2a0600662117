"""Top device operations of the batched uint8 report step, from a trace.

Warms BatchRunner.run_u8 on a batch that mixes uniform noise and
photo-like frames (2 crop boxes each), records a jax.profiler trace of a
few steps, and prints for each device the operations with the most summed
device time (under XLA's names) and the share of the traced window in
which the device ran no operation.

Usage: python tools/trace_top_ops.py [H W B] [--steps N] [--top N]
       [--out DIR]   (where the trace is written; default a temp dir)
"""

from __future__ import annotations

import argparse
import collections
import glob
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def _union_ns(intervals) -> int:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def summarize(xplane_path: str, top: int) -> list:
    """Per device plane and line: (plane/line, window_ns, idle share,
    [(op, ns, n)]), from the plane's "XLA Ops" line, or from each of its
    lines where it has none."""
    import jax

    prof = jax.profiler.ProfileData.from_file(xplane_path)
    rows = []
    for plane in prof.planes:
        if not plane.name.startswith("/device:"):
            continue
        lines = list(plane.lines)
        ops_lines = [ln for ln in lines if ln.name == "XLA Ops"]
        for line in ops_lines or lines:
            evs = [(e.name, e.start_ns, e.end_ns) for e in line.events]
            if not evs:
                continue
            t0 = min(s for _, s, _ in evs)
            t1 = max(e for _, _, e in evs)
            busy = _union_ns((s, e) for _, s, e in evs)
            by = collections.defaultdict(lambda: [0, 0])
            for name, s, e in evs:
                by[name][0] += e - s
                by[name][1] += 1
            ops = sorted(((k, v[0], v[1]) for k, v in by.items()),
                         key=lambda r: -r[1])[:top]
            rows.append((f"{plane.name} [{line.name}]", t1 - t0,
                         1.0 - busy / max(t1 - t0, 1), ops))
    return rows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("shape", nargs="*", type=int, default=[1080, 1920, 32])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    h, w, b = args.shape

    import jax

    import chip_smoke as cs
    from photohive_dsp_tpu import ReportConfig
    from photohive_dsp_tpu.models.batch import BatchRunner

    imgs = np.stack([cs.noise_u8(h, w, i) if i % 2 == 0
                     else cs.structured_u8(h, w, i) for i in range(b)])
    boxes, valid = cs.box_arrays(cs.two_boxes(h, w), b)
    args_d = jax.device_put((imgs, boxes, valid))
    runner = BatchRunner(ReportConfig())
    jax.block_until_ready(runner.run_u8(*args_d))
    jax.block_until_ready(runner.run_u8(*args_d))

    out = args.out or tempfile.mkdtemp(prefix="trace_")
    jax.profiler.start_trace(out)
    for _ in range(args.steps):
        jax.block_until_ready(runner.run_u8(*args_d))
    jax.profiler.stop_trace()
    paths = glob.glob(os.path.join(out, "**", "*.xplane.pb"), recursive=True)
    if not paths:
        raise SystemExit(f"no trace written under {out}")
    dev = jax.devices()[0]
    print(f"trace of {args.steps} run_u8 steps, {b}x{h}x{w} uint8, "
          f"{dev.platform} {dev.device_kind}: {paths[0]}")
    for plane, window, idle, ops in summarize(paths[0], args.top):
        print(f"{plane}: window {window / 1e6:.2f} ms, idle share "
              f"{idle:.4f}")
        for name, ns, n in ops:
            print(f"  {ns / 1e6 / args.steps:10.3f} ms/step "
                  f"x{n // args.steps:<4d} {ns / max(window, 1):6.1%}  "
                  f"{name}")


if __name__ == "__main__":
    main()
