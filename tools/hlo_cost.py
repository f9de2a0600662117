"""Compiled-program cost census for the batched report executable.

Prints XLA's cost_analysis (bytes accessed, flops) for the real u8 batch
program at a given shape on the default backend, plus the largest buffers
materialized between fusions.  Timing-free: the numbers are deterministic
per compile.

Usage: python tools/hlo_cost.py [height width batch]
"""

import os
import re
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax
import jax.numpy as jnp


def main():
    from photohive_dsp_tpu.config import ReportConfig
    from photohive_dsp_tpu.models.pipeline import (ReportTables,
                                                   full_report_batched)

    height, width, batch = 1080, 1920, 16
    if len(sys.argv) >= 4:
        height, width, batch = map(int, sys.argv[1:4])
    cfg = ReportConfig()
    tables = ReportTables.build(height, width, cfg)

    def fn(u8, boxes, valid, tables):
        from photohive_dsp_tpu.ops.colorspace import u8_to_unit_f32
        rgb = u8_to_unit_f32(jnp.moveaxis(u8, -1, 1))
        return full_report_batched(rgb, boxes, valid, tables, cfg)

    u8 = jax.ShapeDtypeStruct((batch, height, width, 3), jnp.uint8)
    boxes = jax.ShapeDtypeStruct((batch, 10, 4), jnp.int32)
    valid = jax.ShapeDtypeStruct((batch, 10), jnp.bool_)

    lowered = jax.jit(fn).lower(u8, boxes, valid, tables)
    compiled = lowered.compile()
    px = batch * height * width
    ca = compiled.cost_analysis()
    if isinstance(ca, list):
        ca = ca[0]
    d = jax.devices()[0]
    print(f"device: {d.platform} {d.device_kind} x{len(jax.devices())}")
    print(f"pixels: {px/1e6:.1f} MP  (batch {batch} x {height}x{width})")
    for key in ("bytes accessed", "flops", "transcendentals"):
        v = ca.get(key)
        if v is not None:
            print(f"{key}: {v:.3e}  ({v/px:.1f} /px)")
    # Per-operand traffic if the backend reports it ('bytes accessed{N}' /
    # 'bytes accessedout{}').
    for k in sorted(ca):
        if k.startswith("bytes accessed") and k != "bytes accessed":
            print(f"  {k}: {ca[k]:.3e}  ({ca[k]/px:.1f} /px)")

    # Largest buffers from the memory analysis + biggest fusions by shape.
    try:
        mem = compiled.memory_analysis()
        print(f"argument size:  {mem.argument_size_in_bytes/1e6:.1f} MB")
        print(f"output size:    {mem.output_size_in_bytes/1e6:.1f} MB")
        print(f"temp size:      {mem.temp_size_in_bytes/1e6:.1f} MB")
        print(f"peak (temp+io): "
              f"{(mem.temp_size_in_bytes+mem.argument_size_in_bytes)/1e6:.1f}"
              " MB")
    except Exception as e:  # pragma: no cover - backend-dependent API
        print(f"memory_analysis unavailable: {e}")

    # Census of buffers actually materialized between fusions: ops defined
    # in the ENTRY computation (fusion bodies are separate computations and
    # don't allocate).  Groups output bytes by (shape, op kind).
    txt = compiled.as_text()
    entry = txt[txt.index("ENTRY "):]
    per_px = px
    agg = {}
    op_re = re.compile(
        r"^\s+\S+ = ([a-z0-9]+)\[([\d,]*)\][^ ]* ([a-z\-]+)", re.M)
    dt_bytes = {"f32": 4, "s32": 4, "u32": 4, "f64": 8, "bf16": 2,
                "f16": 2, "s16": 2, "u16": 2, "pred": 1, "s8": 1, "u8": 1}
    for m in op_re.finditer(entry):
        dt, dims, kind = m.groups()
        if dt not in dt_bytes or not dims:
            continue
        n = int(np.prod([int(d) for d in dims.split(",")])) * dt_bytes[dt]
        if n < per_px:  # ignore sub-1-byte-per-pixel buffers
            continue
        key = (f"{dt}[{dims}]", kind)
        c, tot = agg.get(key, (0, 0))
        agg[key] = (c + 1, tot + n)
    print("materialized ENTRY buffers >= 1 B/px  (shape op: count, "
          "total B/px):")
    rows = sorted(agg.items(), key=lambda kv: -kv[1][1])
    total = 0
    for (shape, kind), (c, tot) in rows[:20]:
        total += tot
        print(f"  {shape:<28} {kind:<12} x{c:<3} {tot/px:8.1f} B/px")
    print(f"  ... total materialized: "
          f"{sum(t for _, (_, t) in rows)/px:.1f} B/px write "
          f"(+ at least the same in reads)")


if __name__ == "__main__":
    main()
