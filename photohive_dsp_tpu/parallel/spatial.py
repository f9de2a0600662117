"""Spatially-sharded single-image report: rows of one image over the
``spatial`` mesh axis.

This is the image-size scaling axis (the image-DSP analogue of sequence/
context parallelism): every stage of the report runs on row-tiles with the
minimum cross-shard communication —

  * statistics / mean saturation: local partial sums -> psum;
  * color palette: local cell histogram -> psum -> replicated selection
    (tiny, O(C^2)) -> local pixel pass -> psum of the (C, 4) palette sums;
  * crop sharpness: 1-row halo exchange (ppermute) so the 3x3 Laplacian at
    tile boundaries sees its true neighbors; box reductions psum;
  * blur profile: distributed 2-D rFFT — local row rFFT along W, all_to_all
    transpose over the interconnect, column FFT along H, local polar-bin
    partial sums -> psum; normalization max via pmax.

Everything the reference computes per image (src/interface.c:20-94) comes
out bit-identical in exact arithmetic to the single-device path; parity is
enforced by tests on an 8-device CPU mesh.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..config import ReportConfig
from ..models.pipeline import ReportData
from ..ops import fft as fftops
from ..ops import quantize
from ..ops.blur import vectorize_blur_profile
from ..ops.colorspace import downsample_rgb, rgb_to_hsv, rgb_to_pgm
from ..ops.geometry import polar_geometry
from ..ops.quantize import OctreeTables
from ..ops.sharpness import TINY_BOX_PX as _TINY_BOX_PX
from .mesh import DATA_AXIS, SPATIAL_AXIS


class ShardedPolarTables(NamedTuple):
    """Per-shard polar bin tables in each shard's local spectrum space."""

    pad_index: np.ndarray    # (n_shards, A*R, Lmax) int32, sentinel = H*Wc
    #                          ((n_shards, 1, 1) dummy when flat_route)
    flat_ids: np.ndarray     # (n_shards, H*Wc) int32, sentinel = A*R
    counts: np.ndarray       # (A*R,) int32 global bin counts
    wc: int                  # columns per shard after the all_to_all
    flat_route: bool         # True: gather table too big (see ops/blur.py
    #                          memory audit); bins reduce via flat_ids


@functools.lru_cache(maxsize=16)
def sharded_polar_tables(height: int, width: int, num_angle_bins: int,
                         num_radius_bins: int, n_shards: int,
                         max_table_bytes: int = None)\
        -> ShardedPolarTables:
    from ..ops.blur import _pad_table_budget

    if max_table_bytes is None:
        max_table_bytes = _pad_table_budget()
    geom = polar_geometry(height, width, num_angle_bins, num_radius_bins)
    wf = geom.fft_width
    wc = -(-wf // n_shards)
    num_bins = num_angle_bins * num_radius_bins
    bin_2d = geom.bin_ids.reshape(height, wf)
    sentinel = np.int32(height * wc)
    l_max = 1
    tables = []
    # Per-shard flat bin ids in the local (height, wc) layout; padded
    # columns past the true spectrum get the out-of-range sentinel bin id
    # (the flat-ids one-hot never matches it).
    ids_flat = np.full((n_shards, height * wc), num_bins, dtype=np.int32)
    for k in range(n_shards):
        c0, c1 = k * wc, min((k + 1) * wc, wf)
        if c1 <= c0:
            tables.append((np.zeros((num_bins, 0), np.int64), None))
            continue
        ids = bin_2d[:, c0:c1]
        rows, cols = np.nonzero(np.ones_like(ids, dtype=bool))
        flat_local = rows * wc + (cols)  # local layout is (height, wc)
        flat_ids = ids.ravel()
        ids_flat[k].reshape(height, wc)[:, :c1 - c0] = ids
        order = np.argsort(flat_ids, kind="stable")
        counts_k = np.bincount(flat_ids, minlength=num_bins)
        l_max = max(l_max, int(counts_k.max()))
        tables.append((order, (flat_ids, flat_local, counts_k)))
    # Same memory-blowup routing as the single-chip tables (ops/blur.py
    # audit: the gather table is ~3.6x the spectrum): above the budget,
    # skip the table build entirely and reduce through flat ids.
    flat_route = num_bins * l_max * n_shards * 4 > max_table_bytes
    if flat_route:
        pad = np.zeros((n_shards, 1, 1), dtype=np.int32)  # shard_map dummy
    else:
        pad = np.full((n_shards, num_bins, l_max), sentinel, dtype=np.int32)
        for k, (order, extra) in enumerate(tables):
            if extra is None:
                continue
            flat_ids, flat_local, counts_k = extra
            starts = np.zeros(num_bins + 1, np.int64)
            np.cumsum(counts_k, out=starts[1:])
            seg_pos = np.arange(flat_ids.size) - starts[flat_ids[order]]
            pad[k, flat_ids[order], seg_pos] = flat_local[order]
    return ShardedPolarTables(pad_index=pad, flat_ids=ids_flat,
                              counts=geom.bin_counts.astype(np.int32),
                              wc=wc, flat_route=flat_route)


def _halo_rows(x: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """(lh, W) -> (lh+2, W): 1-row halo exchange over the spatial axis.

    Edge shards receive zeros from ppermute's missing partners, which is
    exactly the reference's zero padding (src/filtering.c:96)."""
    n = jax.lax.psum(1, axis_name)
    down = [(i, i + 1) for i in range(n - 1)]   # my last row -> next's top
    up = [(i, i - 1) for i in range(1, n)]      # my first row -> prev's bottom
    top_halo = jax.lax.ppermute(x[-1], axis_name, down)
    bottom_halo = jax.lax.ppermute(x[0], axis_name, up)
    return jnp.concatenate([top_halo[None], x, bottom_halo[None]], axis=0)


def _sharded_sharpness(pgm_local: jnp.ndarray, boxes: jnp.ndarray,
                       boxes_valid: jnp.ndarray, row_offset: jnp.ndarray,
                       axis_name: str, any_tiny=None,
                       any_valid=None) -> jnp.ndarray:
    """No-box gate around _sharded_sharpness_impl.

    With zero valid boxes the whole stage (halo exchange, Laplacian,
    box GEMMs, ring corrections) is dead work; the reference skips it
    (README.md:69: ~3 us).  ``any_valid`` lets a vmapped caller pass a
    batch-level predicate computed outside the vmap (a batched cond
    predicate would execute both branches — same design as
    ``any_tiny``).  The predicate is replicated across the spatial axis
    (boxes are), so every shard branches identically and the collectives
    inside the compute branch stay matched."""
    if any_valid is None:
        any_valid = jnp.any(boxes_valid)
    return jax.lax.cond(
        any_valid,
        lambda _: _sharded_sharpness_impl(pgm_local, boxes, boxes_valid,
                                          row_offset, axis_name, any_tiny),
        lambda _: jnp.zeros(boxes_valid.shape, pgm_local.dtype),
        None)


def _sharded_sharpness_impl(pgm_local: jnp.ndarray, boxes: jnp.ndarray,
                            boxes_valid: jnp.ndarray,
                            row_offset: jnp.ndarray,
                            axis_name: str, any_tiny=None) -> jnp.ndarray:
    """Crop sharpness with boxes spanning shards — the fast formulation.

    ONE shared halo-exchanged Laplacian pass per shard (not one masked
    stencil pass per box), per-box reductions as boundary-masked GEMMs,
    and the crop's zero-padding reproduced exactly through ring
    corrections (the sharded counterpart of ops/sharpness.py's batched
    path, reference src/filtering.c:151-183).  The response mean uses the
    exact telescoped ring identity (ops/sharpness._ring_weight_map),
    matching the reference's f64 mean to ~1e-7.

    Like the single-chip batched path, boxes smaller than 4 px in either
    dimension switch the whole call (one lax.cond on the replicated boxes,
    so every shard branches identically) to an exact per-box masked pass.
    ``any_tiny`` lets a vmapped caller pass the predicate computed over
    its WHOLE batch (unbatched under vmap): a batched cond predicate
    would make vmap execute BOTH branches and select — doubling the
    sharpness cost for every image (same batch-level-cond design as
    ops/sharpness.variance_sharpness_batched).  Tiny crops:
    on tiny crops the fast path's E[x^2] - mean^2 assembly cancels ~1e3
    of its own magnitude and leaves ~1e-6 absolute noise, while the
    masked two-pass sum((resp - mean)^2) is exact.

    Every ring quantity is computed on the shard that owns the response
    row it belongs to (halo rows supply the out-of-shard neighbors), so
    the psum never double-counts.
    """
    f32 = pgm_local.dtype
    lh, w = pgm_local.shape
    t, b = boxes[:, 0], boxes[:, 1]
    l, r = boxes[:, 2], boxes[:, 3]

    halo = _halo_rows(pgm_local, axis_name)               # (lh+2, W)
    halo_p = jnp.pad(halo, ((0, 0), (1, 1)))              # (lh+2, W+2)
    resp = (8.0 * pgm_local
            - (halo_p[:-2, :-2] + halo_p[:-2, 1:-1] + halo_p[:-2, 2:]
               + halo_p[1:-1, :-2] + halo_p[1:-1, 2:]
               + halo_p[2:, :-2] + halo_p[2:, 1:-1] + halo_p[2:, 2:]))
    s3 = halo_p[:, :-2] + halo_p[:, 1:-1] + halo_p[:, 2:]  # (lh+2, W)

    ys = row_offset + jnp.arange(lh)                       # (lh,) global
    ys_h = row_offset - 1 + jnp.arange(lh + 2)             # (lh+2,)
    xs = jnp.arange(w)

    rm = ((ys[None] >= t[:, None])
          & (ys[None] < b[:, None])).astype(f32)           # (K, lh)
    cm = ((xs[None] >= l[:, None])
          & (xs[None] < r[:, None])).astype(f32)           # (K, W)
    hi = jax.lax.Precision.HIGHEST

    def bsum(a, row_mask, col_mask):
        per_row = jnp.einsum("hw,kw->kh", a, col_mask, precision=hi)
        return jnp.einsum("kh,kh->k", per_row, row_mask, precision=hi)

    # Exact telescoped ring mean (see ops/sharpness.py): 9-ab split into
    # 3a'+3b'-a'b' boundary-masked GEMMs.
    alpha = rm * (((ys[None] - 1) < t[:, None]).astype(f32)
                  + ((ys[None] + 1) >= b[:, None]).astype(f32))
    beta = cm * (((xs[None] - 1) < l[:, None]).astype(f32)
                 + ((xs[None] + 1) >= r[:, None]).astype(f32))
    s1 = (3.0 * bsum(pgm_local, alpha, cm)
          + 3.0 * bsum(pgm_local, rm, beta)
          - bsum(pgm_local, alpha, beta))
    s1 = jax.lax.psum(s1, axis_name)
    n = jnp.maximum((b - t) * (r - l), 1).astype(f32)
    mean = s1 / n

    s2 = bsum(resp * resp, rm, cm)

    # --- ring corrections: resp_crop = resp_full + corr on the border ---
    # Vertical: rows t and b-1 see the outside rows t-1 / b through the
    # crop's zero padding.  Row extraction one-hots over halo coordinates,
    # gated by ownership of the *response* row (never double-counted).
    own_t = (t >= row_offset) & (t < row_offset + lh)
    own_b = ((b - 1) >= row_offset) & ((b - 1) < row_offset + lh)
    sel_t_h = ((ys_h[None] == (t - 1)[:, None])
               & own_t[:, None]).astype(f32)               # (K, lh+2)
    sel_b_h = ((ys_h[None] == b[:, None])
               & own_b[:, None]).astype(f32)
    cv_t = jnp.einsum("kh,hw->kw", sel_t_h, s3, precision=hi)  # (K, W)
    cv_b = jnp.einsum("kh,hw->kw", sel_b_h, s3, precision=hi)
    sel_t = (ys[None] == t[:, None]).astype(f32)           # (K, lh)
    sel_b1 = (ys[None] == (b - 1)[:, None]).astype(f32)
    resp_t = jnp.einsum("kh,hw->kw", sel_t, resp, precision=hi)
    resp_b = jnp.einsum("kh,hw->kw", sel_b1, resp, precision=hi)
    vert = jnp.sum(cm * (2.0 * (resp_t * cv_t + resp_b * cv_b)
                         + cv_t * cv_t + cv_b * cv_b), axis=1)

    # Horizontal: columns l and r-1 see outside columns l-1 / r on rows
    # inside the box; halo rows supply the y+-1 values at shard edges.
    colsel_lm1 = (jnp.arange(w + 2)[None] == l[:, None]).astype(f32)
    colsel_r = (jnp.arange(w + 2)[None] == (r + 1)[:, None]).astype(f32)
    e_l = jnp.einsum("hw,kw->kh", halo_p, colsel_lm1, precision=hi)
    e_r = jnp.einsum("hw,kw->kh", halo_p, colsel_r, precision=hi)
    ymask_up = ((ys[None] - 1) >= t[:, None]).astype(f32)
    ymask_dn = ((ys[None] + 1) < b[:, None]).astype(f32)

    def ch_of(e):
        return e[:, :-2] * ymask_up + e[:, 1:-1] + e[:, 2:] * ymask_dn

    ch_l = ch_of(e_l)                                      # (K, lh)
    ch_r = ch_of(e_r)
    colsel_l = (xs[None] == l[:, None]).astype(f32)        # (K, W)
    colsel_r1 = (xs[None] == (r - 1)[:, None]).astype(f32)
    resp_l = jnp.einsum("hw,kw->kh", resp, colsel_l, precision=hi)
    resp_r = jnp.einsum("hw,kw->kh", resp, colsel_r1, precision=hi)
    horiz = jnp.sum(rm * (2.0 * (resp_l * ch_l + resp_r * ch_r)
                          + ch_l * ch_l + ch_r * ch_r), axis=1)

    # Corner cross terms 2*cv*ch (all factors live on the corner row's
    # owner), plus the 1-px-thin overlap cross terms.
    ch_l_t = jnp.sum(ch_l * sel_t, axis=1)
    ch_r_t = jnp.sum(ch_r * sel_t, axis=1)
    ch_l_b = jnp.sum(ch_l * sel_b1, axis=1)
    ch_r_b = jnp.sum(ch_r * sel_b1, axis=1)
    cv_t_l = jnp.sum(cv_t * colsel_l, axis=1)
    cv_t_r = jnp.sum(cv_t * colsel_r1, axis=1)
    cv_b_l = jnp.sum(cv_b * colsel_l, axis=1)
    cv_b_r = jnp.sum(cv_b * colsel_r1, axis=1)
    cross = 2.0 * (cv_t_l * ch_l_t + cv_t_r * ch_r_t
                   + cv_b_l * ch_l_b + cv_b_r * ch_r_b)
    thin_v = ((b - 1) == t).astype(f32)   # single row: cv_t,cv_b overlap
    extra_v = thin_v * jnp.sum(cm * (2.0 * cv_t * cv_b), axis=1)
    thin_h = ((r - 1) == l).astype(f32)   # single col: ch_l,ch_r overlap
    extra_h = thin_h * jnp.sum(rm * (2.0 * ch_l * ch_r), axis=1)

    fast_s2 = s2 + vert + horiz + cross + extra_v + extra_h

    def fast_var(_):
        return jax.lax.psum(fast_s2, axis_name) / n - mean * mean

    def masked_var(_):
        # Exact per-box two-pass: mask the crop, halo-exchange the MASKED
        # rows (a boundary row outside the box hands its neighbor zeros,
        # which is the crop's zero padding), per-pixel mean subtraction.
        insf = rm[:, :, None] * cm[:, None, :]             # (K, lh, W)
        m = pgm_local[None] * insf
        nsh = jax.lax.psum(1, axis_name)
        down = [(i, i + 1) for i in range(nsh - 1)]
        up = [(i, i - 1) for i in range(1, nsh)]
        top_h = jax.lax.ppermute(m[:, -1, :], axis_name, down)
        bot_h = jax.lax.ppermute(m[:, 0, :], axis_name, up)
        padded = jnp.concatenate([top_h[:, None], m, bot_h[:, None]],
                                 axis=1)
        p = jnp.pad(padded, ((0, 0), (0, 0), (1, 1)))
        neigh = (p[:, :-2, :-2] + p[:, :-2, 1:-1] + p[:, :-2, 2:]
                 + p[:, 1:-1, :-2] + p[:, 1:-1, 2:]
                 + p[:, 2:, :-2] + p[:, 2:, 1:-1] + p[:, 2:, 2:])
        respm = 8.0 * m - neigh
        s2m = jax.lax.psum(
            jnp.sum(jnp.square(respm - mean[:, None, None]) * insf,
                    axis=(1, 2)), axis_name)
        return s2m / n

    if any_tiny is None:
        tiny = boxes_valid & (((b - t) < _TINY_BOX_PX)
                              | ((r - l) < _TINY_BOX_PX))
        any_tiny = jnp.any(tiny)
    var = jax.lax.cond(any_tiny, masked_var, fast_var, None)
    # Unguarded like the reference (src/filtering.c:174): zero response
    # mean -> IEEE inf/NaN, identically to the single-chip paths.
    return jnp.where(boxes_valid, var / mean, 0.0)


def _sharded_blur_bins(pgm_local: jnp.ndarray, dc: jnp.ndarray,
                       pad_index_local: jnp.ndarray,
                       flat_ids_local: jnp.ndarray,
                       counts_global: jnp.ndarray, wc: int, height: int,
                       width: int, cfg: ReportConfig, axis_name: str,
                       polar_flat: bool = False) -> jnp.ndarray:
    """Distributed 2-D rFFT -> log normalize -> polar bins, psum-merged.

    The local polar partial sums are the static gather against this
    shard's table, or with ``polar_flat`` (gather table over the memory
    budget; ops/blur.py audit) the chunked flat-ids one-hot
    contraction."""
    n = jax.lax.psum(1, axis_name)
    wf = width // 2 + 1
    x = pgm_local - dc
    spec = jnp.fft.rfft(x, axis=1)                       # (lh, Wf)
    spec = jnp.pad(spec, ((0, 0), (0, wc * n - wf)))
    # transpose: row shards -> column shards over the interconnect
    cols = jax.lax.all_to_all(spec, axis_name, split_axis=1, concat_axis=0,
                              tiled=True)                # (Hpad, wc)
    # Row r of the row-FFT stage is image row r, so dropping the padded
    # rows here restores the exact H-point column transform.
    col_spec = jnp.fft.fft(cols[:height], axis=0)
    mag = jnp.square(jnp.real(col_spec)) + jnp.square(jnp.imag(col_spec))
    mx = jax.lax.pmax(jnp.max(mag), axis_name)
    norm = fftops.normalize_fft(mag, mx=mx)
    num_bins = cfg.angle_partitions * cfg.radius_partitions
    if polar_flat:
        from ..ops.blur import polar_bin_sums_flat_xla
        sums = polar_bin_sums_flat_xla(norm.reshape(-1), flat_ids_local,
                                       num_bins)         # (A*R,)
    else:
        flat = jnp.concatenate([norm.reshape(-1),
                                jnp.zeros((1,), norm.dtype)])
        sums = jnp.sum(flat[pad_index_local], axis=1)    # (A*R,)
    sums = jax.lax.psum(sums, axis_name)
    counts = counts_global.astype(norm.dtype)
    means = jnp.where(counts_global > 0, sums / jnp.maximum(counts, 1), 0.0)
    return means.reshape(cfg.angle_partitions, cfg.radius_partitions)


def _dummy_palette(cfg: ReportConfig) -> "quantize.PaletteResult":
    """Shape-correct zeros for the deferred path (replaced by the
    caller's _replace after the post-vmap pass; dead code under XLA)."""
    c = cfg.num_cells
    return quantize.PaletteResult(
        hsv=jnp.zeros((c, 3)), percentages=jnp.zeros((c,)),
        n_valid=jnp.zeros((), jnp.int32),
        parent_ids=jnp.zeros((c,), jnp.int32))


class DeferredPalette(NamedTuple):
    """Palette pixel-pass inputs a vmapped caller runs batched.

    The candidate-width ``lax.cond``/``lax.switch`` needs a SCALAR
    predicate; under the dp-spatial per-image vmap it would batch
    (executing every branch).  Deferring the pixel pass to after the
    vmap lets one batched call carry the whole local batch with a
    scalar max-over-batch predicate — the same design as the
    single-chip batched fast path (quantize.color_palette_batched).
    """

    h: jnp.ndarray        # (P_local,) hue
    s: jnp.ndarray        # (P_local,)
    v: jnp.ndarray        # (P_local,)
    assign: quantize.ParentAssignment   # replicated across the axis
    counts: jnp.ndarray   # (C,) psum-merged global cell counts
    cells: jnp.ndarray    # (P_local,) int32 w/ sentinel C on padded px


def spatial_report_body(rgb_local: jnp.ndarray, down_local: jnp.ndarray,
                        boxes: jnp.ndarray,
                        boxes_valid: jnp.ndarray,
                        pad_index_local: jnp.ndarray,
                        flat_ids_local: jnp.ndarray,
                        octree: OctreeTables, counts_global: jnp.ndarray,
                        wc: int, height: int, width: int, cfg: ReportConfig,
                        axis_name: str = SPATIAL_AXIS,
                        any_tiny=None,
                        any_valid=None,
                        defer_palette: bool = False,
                        polar_flat: bool = False) -> ReportData:
    """Per-shard body computing the full report for one row-sharded image.

    rgb_local:  (3, H/n, W) full-resolution rows (stats, sharpness, blur).
    down_local: (3, H'/n, W') rows of the decimated image (palette, mean
                saturation); the same array as rgb_local when
                downsample_rate == 1.  The decimation itself happens
                outside the shard_map (its stride-(rate-1) row pick is not
                aligned with row shards), and GSPMD reshards the small
                result.  All outputs are fully reduced (identical on every
                shard of the axis).

    With ``defer_palette`` the palette pixel pass and
    finalize are NOT run; the return is ``(ReportData-with-zeroed-palette,
    DeferredPalette)`` and the caller runs the batched pass + psum +
    finalize itself (build_dp_spatial_report does, outside its vmap).
    """
    total = height * width
    n = jax.lax.psum(1, axis_name)                 # static axis size (int)
    rate = cfg.downsample_rate
    d_h = height // rate if rate > 1 else height   # REAL decimated rows
    d_w = width // rate if rate > 1 else width
    d_total = d_h * d_w
    local_h = rgb_local.shape[1]
    d_local_h = down_local.shape[1]
    idx = jax.lax.axis_index(axis_name)
    row_offset = idx * local_h
    # Non-dividing heights arrive zero-row-padded to local_h * n (resp.
    # d_local_h * n); every consumer below masks the padded rows exactly.
    h_padded = local_h * n != height
    d_padded = d_local_h * n != d_h

    def gmean(x):
        return jax.lax.psum(jnp.sum(x), axis_name) / total

    # stats (two-pass, like the reference reducers).  Padded rows are zero,
    # so the mean sums need no mask; the squared deviations do.
    means = [gmean(rgb_local[i]) for i in range(3)]
    if h_padded:
        rv = (row_offset + jnp.arange(local_h) < height
              ).astype(rgb_local.dtype)[:, None]
        stds = [jnp.sqrt(gmean(jnp.square(rgb_local[i] - means[i]) * rv))
                for i in range(3)]
    else:
        stds = [jnp.sqrt(gmean(jnp.square(rgb_local[i] - means[i])))
                for i in range(3)]
    stats = jnp.stack(means + stds)

    h, s, v = rgb_to_hsv(down_local[0], down_local[1], down_local[2])
    pgm = rgb_to_pgm(rgb_local[0], rgb_local[1], rgb_local[2])

    # palette: psum histogram -> replicated selection -> psum pixel sums
    cells = quantize.assign_cells(h, s, v, cfg).reshape(-1)
    if d_padded:
        dv = (idx * d_local_h + jnp.arange(d_local_h)) < d_h     # (d_lh,)
        dv_pix = jnp.broadcast_to(dv[:, None],
                                  (d_local_h, down_local.shape[2]))
        # Out-of-image pixels get the sentinel cell id C, which the
        # histogram and the pixel pass drop exactly.
        cells = jnp.where(dv_pix.reshape(-1), cells,
                          jnp.int32(cfg.num_cells))
        s_bar = jax.lax.psum(jnp.sum(s * dv_pix), axis_name) / d_total
    else:
        s_bar = jax.lax.psum(jnp.sum(s), axis_name) / d_total
    counts = jax.lax.psum(quantize.cell_counts(cells, cfg.num_cells),
                          axis_name)
    assign = quantize.parent_assignment(counts, d_total, cfg, octree)
    if defer_palette:
        deferred = DeferredPalette(h=h.reshape(-1), s=s.reshape(-1),
                                   v=v.reshape(-1), assign=assign,
                                   counts=counts, cells=cells)
        palette = _dummy_palette(cfg)
    else:
        # Scalar tier switch (q=1/8/full, quantize.palette_q_tiers):
        # legal here because this branch is unbatched (the vmapped dp
        # caller defers instead — a batched predicate would execute every
        # tier).  counts/assign are replicated across the axis, so every
        # shard picks the same tier and the psum stays matched.
        sums = jax.lax.psum(
            quantize.palette_q_tiers(
                h.reshape(1, -1), s.reshape(1, -1), v.reshape(1, -1),
                cells[None], jax.tree.map(lambda x: x[None], assign),
                counts[None], cfg, octree)[0],
            axis_name)
        palette = quantize.palette_finalize(sums, assign, d_total, octree)

    sharp = _sharded_sharpness(pgm, boxes, boxes_valid, row_offset,
                               axis_name, any_tiny, any_valid)

    dc = (stats[0] + stats[1] + stats[2]) / 3.0
    bins = _sharded_blur_bins(pgm, dc, pad_index_local, flat_ids_local,
                              counts_global, wc, height, width, cfg,
                              axis_name, polar_flat)
    angles, mags = vectorize_blur_profile(bins, cfg)

    data = ReportData(
        rgb_stats=stats, average_saturation=s_bar,
        palette_hsv=palette.hsv, palette_pct=palette.percentages,
        palette_n=palette.n_valid, palette_ids=palette.parent_ids,
        sharpness=sharp, blur_bins=bins,
        blur_vector_angles=angles, blur_vector_mags=mags,
    )
    if defer_palette:
        return data, deferred
    return data


@functools.lru_cache(maxsize=8)
def build_spatial_report(mesh: Mesh, height: int, width: int,
                         cfg: ReportConfig):
    """Compiled spatially-sharded single-image report over mesh['spatial'].

    Returns fn(rgb (3,H,W), boxes, valid) -> ReportData (replicated).
    """
    n = mesh.shape[SPATIAL_AXIS]
    rate = cfg.downsample_rate
    d_h = height // rate if rate > 1 else height
    hp = -(-height // n) * n          # zero-row-pad to the spatial axis
    d_hp = -(-d_h // n) * n           # (body masks the padded rows exactly)
    tabs = sharded_polar_tables(height, width, cfg.angle_partitions,
                                cfg.radius_partitions, n)
    octree = OctreeTables.for_config(cfg)
    pad_all = jnp.asarray(tabs.pad_index)
    ids_all = jnp.asarray(tabs.flat_ids)
    counts_g = jnp.asarray(tabs.counts)

    def body(rgb_loc, down_loc, boxes, valid, pad_loc, ids_loc, octree_t,
             counts):
        return spatial_report_body(rgb_loc, down_loc, boxes, valid,
                                   pad_loc[0], ids_loc[0], octree_t, counts,
                                   tabs.wc, height, width, cfg,
                                   SPATIAL_AXIS,
                                   polar_flat=tabs.flat_route)

    shard_fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(None, SPATIAL_AXIS, None), P(None, SPATIAL_AXIS, None),
                  P(), P(), P(SPATIAL_AXIS), P(SPATIAL_AXIS), P(), P()),
        out_specs=P(),
        check_vma=False,
    )

    @jax.jit
    def run(rgb, boxes, valid):
        # Decimation happens at jit level: its stride-(rate-1) row pick is
        # not shard-aligned, so GSPMD inserts the (tiny) reshard collective.
        # It reads the REAL rows; padding follows it.
        down = downsample_rgb(rgb, cfg.downsample_rate)
        if hp != height:
            rgb = jnp.pad(rgb, ((0, 0), (0, hp - height), (0, 0)))
        if d_hp != d_h:
            down = jnp.pad(down, ((0, 0), (0, d_hp - d_h), (0, 0)))
        return shard_fn(rgb, down, boxes, valid, pad_all, ids_all, octree,
                        counts_g)

    return run


@functools.lru_cache(maxsize=8)
def build_dp_spatial_report(mesh: Mesh, batch: int, height: int,
                            width: int, cfg: ReportConfig):
    """Full multi-chip step: batch over ``data`` x rows over ``spatial``.

    Returns fn(rgb (B,3,H,W), boxes (B,10,4), valid (B,10)) -> ReportData
    with leading batch dim (sharded over data, replicated over spatial).
    """
    nd = mesh.shape[DATA_AXIS]
    ns = mesh.shape[SPATIAL_AXIS]
    if batch % nd != 0:
        raise ValueError(f"batch {batch} must divide by data={nd}")
    rate = cfg.downsample_rate
    d_h = height // rate if rate > 1 else height
    hp = -(-height // ns) * ns
    d_hp = -(-d_h // ns) * ns
    tabs = sharded_polar_tables(height, width, cfg.angle_partitions,
                                cfg.radius_partitions, ns)
    octree = OctreeTables.for_config(cfg)
    pad_all = jnp.asarray(tabs.pad_index)
    ids_all = jnp.asarray(tabs.flat_ids)
    counts_g = jnp.asarray(tabs.counts)

    def body(rgb_loc, down_loc, boxes, valid, pad_loc, ids_loc, octree_t,
             counts):
        # Batch-level tiny-box predicate, computed OUTSIDE the vmap so the
        # sharpness lax.cond keeps an unbatched predicate (a batched one
        # would execute both branches for every image); same batch-level
        # semantics as ops/sharpness.variance_sharpness_batched.
        tiny = valid & (
            ((boxes[..., 1] - boxes[..., 0]) < _TINY_BOX_PX)
            | ((boxes[..., 3] - boxes[..., 2]) < _TINY_BOX_PX))
        any_tiny = jnp.any(tiny)
        any_valid = jnp.any(valid)

        def one(rgb_i, down_i, boxes_i, valid_i):
            # defer_palette: the candidate-width cond/switch needs a
            # scalar predicate, which this vmap would batch (executing
            # every branch per image); deferring runs ONE batched pass
            # below with a max-over-batch scalar predicate — the
            # single-chip batched design.
            return spatial_report_body(rgb_i, down_i, boxes_i, valid_i,
                                       pad_loc[0], ids_loc[0], octree_t,
                                       counts, tabs.wc, height, width, cfg,
                                       SPATIAL_AXIS, any_tiny, any_valid,
                                       defer_palette=True,
                                       polar_flat=tabs.flat_route)
        data, pal = jax.vmap(one)(rgb_loc, down_loc, boxes, valid)
        d_w = width // rate if rate > 1 else width
        d_total = d_h * d_w
        sums = quantize.palette_q_tiers(
            pal.h, pal.s, pal.v, pal.cells, pal.assign, pal.counts,
            cfg, octree_t)
        sums = jax.lax.psum(sums, SPATIAL_AXIS)
        palette = jax.vmap(
            lambda sm, a: quantize.palette_finalize(
                sm, a, d_total, octree_t))(sums, pal.assign)
        return data._replace(palette_hsv=palette.hsv,
                             palette_pct=palette.percentages,
                             palette_n=palette.n_valid,
                             palette_ids=palette.parent_ids)

    shard_fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(DATA_AXIS, None, SPATIAL_AXIS, None),
                  P(DATA_AXIS, None, SPATIAL_AXIS, None),
                  P(DATA_AXIS), P(DATA_AXIS), P(SPATIAL_AXIS),
                  P(SPATIAL_AXIS), P(), P()),
        out_specs=P(DATA_AXIS),
        check_vma=False,
    )

    @jax.jit
    def run(rgb, boxes, valid):
        down = jax.vmap(
            lambda x: downsample_rgb(x, cfg.downsample_rate))(rgb)
        if hp != height:
            rgb = jnp.pad(rgb, ((0, 0), (0, 0), (0, hp - height), (0, 0)))
        if d_hp != d_h:
            down = jnp.pad(down, ((0, 0), (0, 0), (0, d_hp - d_h), (0, 0)))
        return shard_fn(rgb, down, boxes, valid, pad_all, ids_all, octree,
                        counts_g)

    return run
