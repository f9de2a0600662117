"""Batched, bucketed report execution.

The reference processes one image per call (src/interface.c:20); this
build's throughput comes from batching same-shape images into one compiled
executable (vmap) and sharding the batch over the ``data`` mesh axis.
Mixed-resolution corpora are grouped into shape buckets — one jit cache
entry per (H, W) — and each bucket's batches are padded up to a multiple of
the data-axis size with masked dummy images whose reports are dropped.
"""

from __future__ import annotations

import collections
import functools
import os
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MAX_CROP_BOXES, ReportConfig
from ..ops.colorspace import u8_to_unit_f32
from .pipeline import ReportData, ReportTables, full_report


def _pad_tail(x, pad: int):
    """Append ``pad`` copies of the last batch row, staying on-device for
    jax arrays (np.concatenate on a device array would round-trip the
    whole batch through host memory)."""
    xp = jnp if isinstance(x, jax.Array) else np
    return xp.concatenate([x, xp.repeat(x[-1:], pad, axis=0)])


@functools.lru_cache(maxsize=32)
def _compiled_batch_fn(height: int, width: int, cfg: ReportConfig):
    from .pipeline import full_report_batched

    tables = ReportTables.build(height, width, cfg)
    fn = jax.jit(functools.partial(full_report_batched, cfg=cfg))
    return fn, tables


@functools.lru_cache(maxsize=32)
def _compiled_u8_batch_fn(height: int, width: int, cfg: ReportConfig):
    """Batch fn taking device-resident uint8 (B, H, W, 3) images: the
    host->device transfer moves 4x less data and the planarize/normalize
    runs on-device fused into the pipeline."""
    from .pipeline import full_report_batched

    tables = ReportTables.build(height, width, cfg)

    def fn(u8, boxes, valid, tables):
        rgb = u8_to_unit_f32(jnp.moveaxis(u8, -1, 1))
        return full_report_batched(rgb, boxes, valid, tables, cfg)

    return jax.jit(fn), tables


# Images at or above this many megapixels route to the spatially-sharded
# path when the mesh has a spatial axis (SURVEY.md §7.4 routing policy:
# replicate small images over ``data``, shard >=4K-class ones over
# ``spatial`` so each chip holds 1/n of the rows).
SPATIAL_ROUTE_MP = float(os.environ.get("PHOTOHIVE_SPATIAL_MP", "8.0"))


@functools.lru_cache(maxsize=8)
def _dp_spatial_u8_fn(mesh, batch: int, height: int, width: int,
                      cfg: ReportConfig):
    from ..parallel.spatial import build_dp_spatial_report

    run = build_dp_spatial_report(mesh, batch, height, width, cfg)

    @jax.jit
    def fn(u8, boxes, valid):
        rgb = u8_to_unit_f32(jnp.moveaxis(u8, -1, 1))
        return run(rgb, boxes, valid)

    return fn


class BatchRunner:
    """Executes same-shape image batches through one compiled report fn.

    Optionally shards the batch over a mesh's ``data`` axis (in which case
    batch sizes are padded to a multiple of the axis size).  On meshes
    with a ``spatial`` axis, images of at least ``spatial_route_mp``
    megapixels run through the spatially-sharded body (rows over
    ``spatial`` x batch over ``data``) instead of being replicated.
    """

    def __init__(self, cfg: ReportConfig, mesh=None,
                 spatial_route_mp: float = SPATIAL_ROUTE_MP):
        self.cfg = cfg
        self.mesh = mesh
        self.spatial_route_mp = spatial_route_mp
        self._data_axis = None
        self._spatial_axis = None
        self._flat_mesh = None
        if mesh is not None:
            from ..parallel.mesh import DATA_AXIS, SPATIAL_AXIS
            from ..parallel.sharding import flat_data_mesh
            self._spatial_axis = mesh.shape.get(SPATIAL_AXIS, 1)
            # Small images fold the spatial axis into data (all devices
            # data-parallel); only the spatial route uses the 2-D mesh.
            self._flat_mesh = flat_data_mesh(mesh)
            self._data_axis = self._flat_mesh.shape[DATA_AXIS]
            self._spatial_route_batch = mesh.shape[DATA_AXIS]

    def routes_spatially(self, height: int, width: int) -> bool:
        """True when (height, width) images run on the spatial path."""
        return bool(self._spatial_axis and self._spatial_axis > 1
                    and height * width >= self.spatial_route_mp * 1e6)

    def _norm_boxes(self, b, boxes, boxes_valid):
        if boxes is None:
            return (np.zeros((b, MAX_CROP_BOXES, 4), np.int32),
                    np.zeros((b, MAX_CROP_BOXES), bool))
        if boxes_valid is None:
            raise ValueError("boxes_valid must accompany boxes "
                             "(use set_bounding_boxes to build both)")
        return boxes, boxes_valid

    def run_u8(self, images_u8, boxes=None, boxes_valid=None) -> ReportData:
        """images_u8: (B, H, W, 3) uint8 (numpy or device array)."""
        b, h, w, _ = images_u8.shape
        boxes, boxes_valid = self._norm_boxes(b, boxes, boxes_valid)
        if self.routes_spatially(h, w):
            pad = (-b) % self._spatial_route_batch
            if pad:
                images_u8 = _pad_tail(images_u8, pad)
                boxes = _pad_tail(boxes, pad)
                boxes_valid = _pad_tail(boxes_valid, pad)
            fn = _dp_spatial_u8_fn(self.mesh, b + pad, h, w, self.cfg)
            out = fn(jnp.asarray(images_u8), jnp.asarray(boxes),
                     jnp.asarray(boxes_valid))
            return jax.tree.map(lambda x: x[:b], out) if pad else out
        if self.mesh is not None:
            from ..parallel.sharding import data_parallel_report_u8
            pad = (-b) % self._data_axis
            if pad:
                images_u8 = _pad_tail(images_u8, pad)
                boxes = _pad_tail(boxes, pad)
                boxes_valid = _pad_tail(boxes_valid, pad)
            fn, tables = data_parallel_report_u8(h, w, self.cfg,
                                                 self._flat_mesh)
            out = fn(jnp.asarray(images_u8), jnp.asarray(boxes),
                     jnp.asarray(boxes_valid), tables)
            return jax.tree.map(lambda x: x[:b], out) if pad else out
        fn, tables = _compiled_u8_batch_fn(h, w, self.cfg)
        return fn(jnp.asarray(images_u8), jnp.asarray(boxes),
                  jnp.asarray(boxes_valid), tables)

    def run_stream_u8(self, batches, prefetch: int = 0)\
            -> Iterator[ReportData]:
        """Streaming batches through the compiled pipeline.

        By default uploads are sequential device_puts.  ``prefetch`` > 0
        device_puts that many batches ahead in a background thread,
        overlapping upload with compute (the standard double-buffered
        input pipeline, SURVEY.md §7.4)."""
        if prefetch > 0:
            from ..utils.io import prefetch_iter
            staged = ((jax.device_put(i), jax.device_put(b),
                       jax.device_put(v)) for i, b, v in batches)
            for images_u8, boxes, valid in prefetch_iter(staged, prefetch):
                yield self.run_u8(images_u8, boxes, valid)
            return
        for images_u8, boxes, valid in batches:
            yield self.run_u8(jax.device_put(images_u8),
                              jax.device_put(boxes), jax.device_put(valid))

    def run(self, images: np.ndarray, boxes: Optional[np.ndarray] = None,
            boxes_valid: Optional[np.ndarray] = None) -> ReportData:
        """images: (B, 3, H, W) float32; returns batched ReportData (B, ...)."""
        b, _, h, w = images.shape
        boxes, boxes_valid = self._norm_boxes(b, boxes, boxes_valid)
        # The spatial route only shards the batch over the 2-D mesh's data
        # axis (rows take the spatial axis), so it needs less padding than
        # the flat all-devices data axis the replicated route uses.
        if self.routes_spatially(h, w):
            pad = (-b) % self._spatial_route_batch
        elif self._data_axis:
            pad = (-b) % self._data_axis
        else:
            pad = 0
        if pad:
            images = _pad_tail(images, pad)
            boxes = _pad_tail(boxes, pad)
            boxes_valid = _pad_tail(boxes_valid, pad)

        if self.routes_spatially(h, w):
            from ..parallel.spatial import build_dp_spatial_report
            fn = build_dp_spatial_report(self.mesh, b + pad, h, w, self.cfg)
            out = fn(jnp.asarray(images), jnp.asarray(boxes),
                     jnp.asarray(boxes_valid))
        else:
            if self.mesh is not None:
                from ..parallel.sharding import data_parallel_report
                fn, tables = data_parallel_report(h, w, self.cfg,
                                                  self._flat_mesh)
            else:
                fn, tables = _compiled_batch_fn(h, w, self.cfg)
            out = fn(jnp.asarray(images), jnp.asarray(boxes),
                     jnp.asarray(boxes_valid), tables)
        if pad:
            out = jax.tree.map(lambda x: x[:b], out)
        return out


def warmup(shapes: Sequence[Tuple[int, int]], cfg: ReportConfig,
           mesh=None, batch_size: int = 32) -> int:
    """Pre-compile the uint8 batch executable for each (H, W) shape.

    First compile of a new image shape costs tens of seconds; a serving
    process calls this at startup (or after a deploy, to repopulate the
    persistent compilation cache) so the first real batch runs warm.
    Uses AOT lowering on abstract shapes — nothing executes, no batch
    memory is allocated.  Returns the number of executables compiled.
    Spatially-routed shapes compile on first use (they depend on the
    mesh's spatial axis, not just the shape).
    """
    runner = BatchRunner(cfg, mesh=mesh)
    n = 0
    for h, w in shapes:
        if runner.routes_spatially(h, w):
            continue
        if mesh is not None:
            from ..parallel.sharding import data_parallel_report_u8
            fn, tables = data_parallel_report_u8(h, w, cfg,
                                                 runner._flat_mesh)
            b = batch_size + ((-batch_size) % runner._data_axis)
        else:
            fn, tables = _compiled_u8_batch_fn(h, w, cfg)
            b = batch_size
        args = (jax.ShapeDtypeStruct((b, h, w, 3), jnp.uint8),
                jax.ShapeDtypeStruct((b, MAX_CROP_BOXES, 4), jnp.int32),
                jax.ShapeDtypeStruct((b, MAX_CROP_BOXES), jnp.bool_),
                tables)
        fn.lower(*args).compile()
        n += 1
    return n


def image_hw(img: np.ndarray) -> Tuple[int, int]:
    """Spatial shape of either a (3, H, W) float or (H, W, 3) uint8 image.

    The layout contract is enforced (a float (H, W, 3) image would
    otherwise flow through with transposed dims and produce a silently
    garbage report)."""
    if img.ndim != 3:
        raise ValueError(f"expected a 3-D image array, got {img.shape}")
    if img.dtype == np.uint8:
        if img.shape[-1] != 3:
            raise ValueError(f"uint8 images must be (H, W, 3), "
                             f"got {img.shape}")
        return img.shape[0], img.shape[1]
    if img.shape[0] != 3:
        raise ValueError(f"float images must be planar (3, H, W), "
                         f"got {img.shape} {img.dtype}")
    return img.shape[1], img.shape[2]


def _bucket_key(img: np.ndarray) -> Tuple[int, int, bool]:
    """Bucket images by (H, W, is_uint8): the two layouts stack into
    different array shapes, so they must never share a np.stack bucket."""
    h, w = image_hw(img)
    return h, w, img.dtype == np.uint8


def bucket_by_shape(items: Iterable[Tuple[object, np.ndarray]])\
        -> Dict[Tuple[int, int], List[Tuple[object, np.ndarray]]]:
    """Group (key, image) pairs by spatial shape."""
    buckets: Dict[Tuple[int, int], list] = collections.defaultdict(list)
    for key, img in items:
        buckets[image_hw(img)].append((key, img))
    return dict(buckets)


def run_corpus(images: Iterable[Tuple[object, np.ndarray]],
               cfg: ReportConfig, mesh=None, batch_size: int = 32,
               spatial_route_mp: float = SPATIAL_ROUTE_MP)\
        -> Iterator[Tuple[object, ReportData]]:
    """Stream reports for a mixed-resolution corpus.

    Truly streaming: images accumulate into per-shape buckets and a bucket
    flushes as soon as it holds ``batch_size`` images (remainders flush at
    end of stream), so memory stays O(num_shapes * batch_size) regardless of
    corpus size.  Yields (key, per-image ReportData).  On meshes with a
    spatial axis, images >= ``spatial_route_mp`` MP run row-sharded
    (see BatchRunner).
    """
    runner = BatchRunner(cfg, mesh=mesh, spatial_route_mp=spatial_route_mp)
    buckets: Dict[Tuple[int, int], list] = collections.defaultdict(list)

    def flush(group):
        h, w = image_hw(group[0][1])
        # Spatially-routed (>= spatial_route_mp MP) shapes run in small
        # sub-batches of the mesh's data-axis quantum instead of the full
        # batch_size: one 32-wide batch of 8+ MP images would hold
        # gigabytes of per-image pipeline intermediates live at once, and
        # the row-sharding already supplies the parallelism.
        quantum = batch_size
        if runner.routes_spatially(h, w):
            quantum = runner._spatial_route_batch
        for c0 in range(0, len(group), quantum):
            chunk = group[c0:c0 + quantum]
            arr = np.stack([img for _, img in chunk])
            # pad partial batches up to the quantum so each image shape
            # compiles exactly one executable (a fresh compile costs far
            # more than the wasted rows)
            n_real = arr.shape[0]
            if n_real < quantum:
                arr = np.concatenate(
                    [arr, np.repeat(arr[-1:], quantum - n_real, axis=0)])
            if arr.dtype == np.uint8:
                # (B, H, W, 3) uint8: a quarter of the f32 upload, and the
                # planarize runs on-device.
                out = runner.run_u8(arr)
            else:
                out = runner.run(arr.astype(np.float32))
            out_np = jax.device_get(out)  # one transfer for all leaves
            for j, (key, _) in enumerate(chunk):
                yield key, jax.tree.map(lambda x, j=j: x[j], out_np)

    # Spatially-routed shapes flush at the mesh's data-axis quantum, not
    # batch_size: 32 x 8+ MP uint8 images would otherwise sit in host RAM
    # (~0.75+ GB per bucket) before the first flush even though the flush
    # itself runs them in data-quantum sub-batches anyway.
    thresholds: Dict[Tuple[int, int, bool], int] = {}
    for key, img in images:
        bkey = _bucket_key(img)
        buckets[bkey].append((key, img))
        if bkey not in thresholds:
            thresholds[bkey] = (runner._spatial_route_batch
                                if runner.routes_spatially(*bkey[:2])
                                else batch_size)
        if len(buckets[bkey]) >= thresholds[bkey]:
            yield from flush(buckets.pop(bkey))
    for group in buckets.values():
        yield from flush(group)
