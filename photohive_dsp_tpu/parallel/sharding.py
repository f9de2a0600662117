"""Data-parallel batch execution: images sharded over the ``data`` mesh axis.

Each image's report is independent, so the batch axis partitions trivially —
no cross-image collectives; the win is pure throughput.  The body runs under
``jax.shard_map`` so each shard executes the full batched pipeline on its
local slice, with the palette tier switch decided per shard.  Mixed
resolutions are handled by the bucketing layer (models/batch.py), one
compiled executable per bucket shape.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..config import ReportConfig
from ..models.pipeline import ReportTables
from .mesh import DATA_AXIS, SPATIAL_AXIS


def _dp_shard_map(mesh: Mesh, body):
    """shard_map wrapper: batch over ``data``, tables replicated."""
    # check_vma=False: the body is purely per-shard local (no collectives);
    # the varying-manual-axes typecheck otherwise rejects scans whose carry
    # init is a replicated constant (quantize.py's insertion-sort scan).
    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS), P()),
        out_specs=P(DATA_AXIS), check_vma=False)


@functools.lru_cache(maxsize=16)
def data_parallel_report(height: int, width: int, cfg: ReportConfig,
                         mesh: Mesh):
    """Compiled batch-report step with the batch dim sharded over ``data``.

    Returns (fn, tables); fn(batch_rgb, boxes, valid, tables) -> ReportData
    with leading batch dimension.  Batch size must be a multiple of the
    data-axis size (pad at the caller; models/batch.py does).
    """
    from ..models.pipeline import full_report_batched

    tables = ReportTables.build(height, width, cfg)

    def body(rgb, boxes, valid, tbl):
        return full_report_batched(rgb, boxes, valid, tbl, cfg)

    return jax.jit(_dp_shard_map(mesh, body)), tables


@functools.lru_cache(maxsize=16)
def data_parallel_report_u8(height: int, width: int, cfg: ReportConfig,
                            mesh: Mesh):
    """uint8 variant: fn(u8 (B,H,W,3), boxes, valid, tables) -> ReportData.

    The host->device transfer moves 4x less data than f32 and the
    planarize/normalize runs on-device inside each shard.
    """
    from ..models.pipeline import full_report_batched

    tables = ReportTables.build(height, width, cfg)

    def body(u8, boxes, valid, tbl):
        from ..ops.colorspace import u8_to_unit_f32
        rgb = u8_to_unit_f32(jnp.moveaxis(u8, -1, 1))
        return full_report_batched(rgb, boxes, valid, tbl, cfg)

    return jax.jit(_dp_shard_map(mesh, body)), tables


def flat_data_mesh(mesh: Mesh) -> Mesh:
    """All of ``mesh``'s devices as one pure-``data`` axis.

    Small images don't use the spatial axis; folding it into ``data``
    means a dp x sp mesh still data-parallelizes small batches over every
    device instead of replicating the work ``spatial``-fold.
    """
    devs = mesh.devices.reshape(-1, 1)
    if devs.shape[0] == mesh.shape[DATA_AXIS]:
        return mesh
    return Mesh(devs, (DATA_AXIS, SPATIAL_AXIS))
