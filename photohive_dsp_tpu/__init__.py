"""photohive_dsp_tpu — JAX image-DSP feature-extraction framework.

A ground-up JAX/XLA rebuild of the capabilities of the PhotoHive_DSP
C/ctypes library (the reference): per-image
brightness/contrast statistics, average saturation, HSV-quantized color
palette, Laplacian-variance crop sharpness, and the 2-D-FFT polar blur
profile with directional blur vectors — as one fused, jit-compiled,
batchable, mesh-shardable pipeline.

Public API (parity with reference __init__.py / core.py):
    get_report(image, salient_characters=None, **knobs) -> Report
    set_bounding_boxes(list_of_dicts) -> crop-box arrays
    ReportConfig, Report, full_report (the jittable pipeline)
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def _cache_dir() -> str:
    """<checkout>/.jax_cache, found from this file.

    XLA:CPU cache entries embed the compiling machine's CPU features, and
    loading one on a plainer host can crash or run slower, so CPU runs
    keep their entries in a subdirectory named by a hash of the host's
    CPU flags.  A GPU run's path does not depend on the host CPU."""
    import hashlib
    import os
    import platform

    root = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_cache")
    if os.environ.get("JAX_PLATFORMS") != "cpu":
        return root
    sig = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    sig += " ".join(sorted(line.split(":", 1)[1].split()))
                    break
    except OSError:
        pass
    return os.path.join(root,
                        "cpu_" + hashlib.sha256(sig.encode()).hexdigest()[:12])


def _enable_compilation_cache() -> None:
    """Persist XLA compilations across processes.

    First-compile latency for a new image shape is tens of seconds; the
    persistent cache makes every later process start warm.  Where
    JAX_COMPILATION_CACHE_DIR is set, JAX already uses it and nothing is
    changed here; PHOTOHIVE_NO_COMPILATION_CACHE=1 opts out."""
    import os

    import jax

    if os.environ.get("PHOTOHIVE_NO_COMPILATION_CACHE") \
            or jax.config.jax_compilation_cache_dir is not None:
        return
    jax.config.update("jax_compilation_cache_dir", _cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2)


_enable_compilation_cache()

from .config import (MAX_CROP_BOXES, NUM_BLUR_VECTORS, ReportConfig,
                     check_image_dims)
from .models.pipeline import (ReportData, ReportTables, full_report,
                              jitted_full_report)
from .ops.colorspace import crop_image, crop_pgm
from .report import Report

__version__ = "0.1.0"

__all__ = [
    "ReportConfig", "Report", "ReportData", "ReportTables", "full_report",
    "get_report", "set_bounding_boxes", "crop_image", "crop_pgm",
    "__version__",
]


def set_bounding_boxes(bounding_boxes: Sequence[dict])\
        -> Tuple[np.ndarray, np.ndarray]:
    """Build the fixed-shape crop-box tensors.

    Same input contract as the reference set_bounding_boxes (core.py:489-515):
    a list of dicts with 'top', 'bottom', 'left', 'right'; at most
    MAX_CROP_BOXES boxes.
    Returns (boxes (10, 4) int32, valid (10,) bool).
    """
    n = len(bounding_boxes)
    if n > MAX_CROP_BOXES:
        raise ValueError(f"at most {MAX_CROP_BOXES} bounding boxes supported")
    boxes = np.zeros((MAX_CROP_BOXES, 4), np.int32)
    valid = np.zeros((MAX_CROP_BOXES,), bool)
    for i, bb in enumerate(bounding_boxes):
        boxes[i] = (bb["top"], bb["bottom"], bb["left"], bb["right"])
        valid[i] = True
    return boxes, valid


def _image_to_planar(image) -> np.ndarray:
    """PIL image or HxWx3 uint8/float array -> (3, H, W) float32 in [0,1]."""
    arr = np.asarray(image)
    if arr.ndim != 3 or arr.shape[2] < 3:
        raise ValueError("expected an RGB image (H, W, 3)")
    arr = arr[:, :, :3]
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    else:
        arr = arr.astype(np.float32)
    return np.moveaxis(arr, -1, 0)


def get_report(image, salient_characters=None, *,
               config: Optional[ReportConfig] = None,
               **knobs) -> Optional[Report]:
    """Compute the full photo report for one image.

    ``image`` is a PIL image or an (H, W, 3) array.  ``salient_characters``
    is the output of set_bounding_boxes (or None).  Extra keyword arguments
    are ReportConfig fields (h_partitions=18, radius_partitions=40, ...),
    mirroring the reference get_report signature (core.py:442-448).

    Returns None (with a message) on invalid input, like the reference's
    NULL-report path (core.py:476-478, src/utilities.c:64-87).
    """
    cfg = config if config is not None else ReportConfig(**knobs)
    cfg.validate()
    rgb = _image_to_planar(image)
    _, height, width = rgb.shape
    ok, msg = check_image_dims(height, width)
    if not ok:
        print(f"Failed to get report data: {msg}")
        return None

    if salient_characters is None:
        boxes = np.zeros((MAX_CROP_BOXES, 4), np.int32)
        valid = np.zeros((MAX_CROP_BOXES,), bool)
        num_boxes = 0
    else:
        boxes, valid = salient_characters
        num_boxes = int(valid.sum())

    # Route through the batched pipeline with B=1: the same compiled
    # program BatchRunner runs.
    import jax

    from .models.batch import _compiled_batch_fn

    fn, tables = _compiled_batch_fn(height, width, cfg)
    data = fn(rgb[None], boxes[None], valid[None], tables)
    data = jax.tree.map(lambda x: x[0], data)
    return Report(data, height, width, num_boxes=num_boxes, config=cfg)
