"""AOT serving artifacts: serialized, version-pinned report executables.

The reference ships a shared library whose ABI pins its behavior
(photohive_dsp's compiled .so, loaded via ctypes in lib.py); the
JAX analogue of a deployable compute artifact is a ``jax.export``
module — the full batched report program captured as StableHLO, with the
shape/config-static tables embedded as constants.  A serving process can
then run the exact bytes that were validated, independent of the Python
code drifting underneath it.

Workflow:
    blob = export_report(1080, 1920, cfg, batch_size=16)   # bytes
    Path("report_1080p.jaxexport").write_bytes(blob)
    ...
    fn = load_report(blob)          # (u8 BHW3, boxes, valid) -> ReportData
    data = fn(u8_batch, boxes, valid)

The exported calling convention is the uint8 serving entry (the same
one models/batch uses): device-resident (B, H, W, 3) uint8 plus the
(B, 10, 4)/(B, 10) crop-box tensors.  Tables are embedded, so the
artifact is self-contained.

The container is this module's own: a JSON header (avals, shardings,
platforms, calling convention, the jax version) and the StableHLO
bytecode.  jax's own ``Exported.serialize`` needs the ``flatbuffers``
package, which GPU serving hosts need not have.  load_report rebuilds
the ``jax.export.Exported`` through its constructor, whose fields are
jax's private ones, so an artifact is tied to the jax version that wrote
it: load_report refuses an artifact of another jax version, and bytes
written by ``Exported.serialize``; export again with export_report.

Determinism contract: a given artifact always produces identical
outputs for identical inputs.  Between an artifact and the *live* jit (or
between artifacts exported under different jax/XLA versions),
fusion/FMA-contraction differences can round f32 at the last ulp,
which may hop pixels sitting exactly on an HSV quantization-cell
boundary and swap near-tied saliency pairs — the validated artifact,
not the live code, is the serving source of truth
(tests/test_serving.py pins the drift bound).
"""

from __future__ import annotations

import json
from typing import Callable, Union

import jax
import jax.numpy as jnp
import numpy as np

from .config import MAX_CROP_BOXES, ReportConfig
from .models.pipeline import ReportData, ReportTables, full_report_batched

_MAGIC = b"photohive-report-export 1\n"
_IN_TREE = jax.tree.structure(((0, 0, 0), {}))
_OUT_TREE = jax.tree.structure(ReportData(*[0] * len(ReportData._fields)))


def _serialize(exp: jax.export.Exported) -> bytes:
    if (exp.in_tree != _IN_TREE or exp.out_tree != _OUT_TREE
            or exp.ordered_effects or exp.unordered_effects
            or exp.disabled_safety_checks):
        raise ValueError("not a report program export")

    def aval(a):
        return {"shape": ",".join(str(d) for d in a.shape),
                "dtype": np.dtype(a.dtype).name}

    def sharding(s):
        return None if s is None else s.to_proto().SerializeToString().hex()

    header = {
        "fun_name": exp.fun_name,
        "in_avals": [aval(a) for a in exp.in_avals],
        "out_avals": [aval(a) for a in exp.out_avals],
        "in_shardings": [sharding(s) for s in exp.in_shardings_hlo],
        "out_shardings": [sharding(s) for s in exp.out_shardings_hlo],
        "nr_devices": exp.nr_devices,
        "platforms": list(exp.platforms),
        "calling_convention_version": exp.calling_convention_version,
        "module_kept_var_idx": list(exp.module_kept_var_idx),
        "uses_global_constants": exp.uses_global_constants,
        "jax_version": jax.__version__,
    }
    return (_MAGIC + json.dumps(header).encode() + b"\n"
            + exp.mlir_module_serialized)


def _deserialize(blob: bytes) -> jax.export.Exported:
    from jax._src.lib import xla_client

    if not blob.startswith(_MAGIC):
        raise ValueError("not an export_report artifact (bytes from "
                         "jax's Exported.serialize included): export it "
                         "again with export_report")
    head, module = blob[len(_MAGIC):].split(b"\n", 1)
    h = json.loads(head)
    if h.get("jax_version") != jax.__version__:
        raise ValueError(f"artifact written by jax {h.get('jax_version')}, "
                         f"this is jax {jax.__version__}: export it again "
                         f"with export_report")
    scope = jax.export.SymbolicScope()

    def aval(a):
        return jax.core.ShapedArray(
            jax.export.symbolic_shape(a["shape"], scope=scope),
            np.dtype(a["dtype"]))

    def sharding(x):
        if x is None:
            return None
        proto = xla_client.OpSharding()
        proto.ParseFromString(bytes.fromhex(x))
        return xla_client.HloSharding.from_proto(proto)

    n_in, n_out = len(h["in_avals"]), len(h["out_avals"])
    return jax.export.Exported(
        fun_name=h["fun_name"], in_tree=_IN_TREE,
        in_avals=tuple(aval(a) for a in h["in_avals"]), out_tree=_OUT_TREE,
        out_avals=tuple(aval(a) for a in h["out_avals"]),
        _has_named_shardings=False, _in_named_shardings=(None,) * n_in,
        _out_named_shardings=(None,) * n_out,
        in_shardings_hlo=tuple(sharding(x) for x in h["in_shardings"]),
        out_shardings_hlo=tuple(sharding(x) for x in h["out_shardings"]),
        nr_devices=h["nr_devices"], platforms=tuple(h["platforms"]),
        ordered_effects=(), unordered_effects=(), disabled_safety_checks=(),
        mlir_module_serialized=module,
        calling_convention_version=h["calling_convention_version"],
        module_kept_var_idx=tuple(h["module_kept_var_idx"]),
        uses_global_constants=h["uses_global_constants"], _get_vjp=None)


def export_report(height: int, width: int,
                  cfg: ReportConfig | None = None, *,
                  batch_size: Union[int, str] = 16,
                  mesh=None) -> bytes:
    """Serialize the batched uint8 report program for one (H, W, config).

    ``batch_size`` may be an int (artifact pinned to that exact batch)
    or the string ``"dynamic"`` — a symbolic batch dimension
    (jax.export shape polymorphism): ONE artifact then serves any batch
    size, recompiling per concrete size at load site like a normal jit.

    ``mesh`` (a jax.sharding.Mesh) exports the DATA-PARALLEL program
    with its shardings baked in: the artifact then requires the SAME
    device count at load time, ``batch_size`` must divide the device
    count, and inputs must be device_put with the batch axis sharded
    (load_report(mesh=...) handles that).  Collective-free by
    construction (the data axis needs none), so the artifact scales
    per-chip throughput with the mesh.  Dynamic batch is not supported
    with a mesh (per-shard shapes must be static).

    Returns the serialized artifact bytes.
    """
    cfg = cfg or ReportConfig()
    cfg.validate()

    if mesh is not None:
        if batch_size == "dynamic":
            raise ValueError("dynamic batch is not supported with a mesh "
                             "(per-shard shapes must be static)")
        from .parallel.sharding import (data_parallel_report_u8,
                                        flat_data_mesh)
        fmesh = flat_data_mesh(mesh)
        b = int(batch_size)
        if b % fmesh.size:
            raise ValueError(f"batch_size {b} must divide the mesh's "
                             f"{fmesh.size} devices")
        dp_fn, tables = data_parallel_report_u8(height, width, cfg, fmesh)
        fn = jax.jit(lambda u8, bx, vl: dp_fn(u8, bx, vl, tables))
    else:
        tables = ReportTables.build(height, width, cfg)

        @jax.jit
        def fn(u8, boxes, valid):
            from .ops.colorspace import u8_to_unit_f32
            rgb = u8_to_unit_f32(jnp.moveaxis(u8, -1, 1))
            return full_report_batched(rgb, boxes, valid, tables, cfg)

        if batch_size == "dynamic":
            b, = jax.export.symbolic_shape("b")
        else:
            b = int(batch_size)
    args = (jax.ShapeDtypeStruct((b, height, width, 3), jnp.uint8),
            jax.ShapeDtypeStruct((b, MAX_CROP_BOXES, 4), jnp.int32),
            jax.ShapeDtypeStruct((b, MAX_CROP_BOXES), jnp.bool_))
    return _serialize(jax.export.export(fn)(*args))


def load_report(blob: Union[bytes, bytearray], *, mesh=None) -> Callable:
    """Rehydrate an export_report artifact into a callable.

    The callable takes (u8 (B,H,W,3), boxes (B,10,4) int32,
    valid (B,10) bool) with the exported batch/shape and returns a
    ReportData (leading batch dim).  For a mesh-exported artifact, pass
    a mesh of the SAME device count: inputs are device_put batch-sharded
    over it before the call (the jax.export calling convention for
    multi-device modules)."""
    call = jax.jit(_deserialize(bytes(blob)).call)
    if mesh is None:
        return call
    from jax.sharding import NamedSharding, PartitionSpec
    from .parallel.mesh import DATA_AXIS
    from .parallel.sharding import flat_data_mesh
    sh = NamedSharding(flat_data_mesh(mesh), PartitionSpec(DATA_AXIS))

    def sharded_call(u8, boxes, valid):
        return call(jax.device_put(u8, sh), jax.device_put(boxes, sh),
                    jax.device_put(valid, sh))

    return sharded_call
