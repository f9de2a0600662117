"""HSV-grid color quantization ("octree") -> fixed-shape color palette.

reference: src/color_quantization.c.  The reference is a linked-list pixel
bucketing structure; the reformulation keeps every step as
fixed-shape dense math:

  1. **Cell assignment** (arm_octree, :108-161): per-pixel integer cell id
     over C = h*s*v + v + 1 cells.  The reference's gray-cell index contains
     a premature int cast — ``(int)(v - black)`` is always 0 for v<1 — so all
     gray pixels land in the *first* gray cell; reproduced faithfully.
  2. **Cell histogram**: a scatter-add of one per pixel into C bins.
  3. **Saliency ordering** (find_valid_octree_parents, :174-203 +
     custom_sort src/utilities.c:132-153): the reference insertion-sorts cell
     ids with the comparator ``(int)(saliency_b - saliency_a)`` — a
     *margin-1, non-transitive* float32 comparison.  We emulate the insertion
     sort exactly with a fori_loop that computes each element's final bubble
     position via a vectorized trailing-run scan (O(C) work per step, C=112
     for default config).  All saliency arithmetic is float32, matching the C
     ``float`` type (src/color_quantization.c:588-595).
  4. **Coverage selection**: cumulative sum of sorted quantities against the
     integer pixel-goal (:184-199).
  5. **Nearest-parent regrouping** (group_irregular_pixels, :342-479): each
     non-parent cell maps to the nearest valid parent under the cell-center
     distance heuristic.  Exact float64 distance *ties* are detected via the
     precomputed integer rank table (ops/geometry.py); tied cells fall back
     to per-pixel Euclidean assignment among the tied parents — the intended
     semantics of get_distance_pixel_to_parent (:303-311; the C function is
     missing its return statement, i.e. undefined behavior, so we implement
     the distance it computes).
  6. **Palette averaging** (calculate_avg_hsv, :510-576): per-parent means
     with the hue-rotation offset trick (rotate by 180-parent_h, wrap, mean,
     rotate back), from per-parent [sum wrapped-hue, sum s, sum v, count]
     accumulated in one pass over pixels (a scan of segment sums over
     64k-pixel chunks, as masked reductions so that the sums do not
     depend on the order in which the device adds).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ReportConfig
from .geometry import octree_geometry

_CHUNK = 1 << 16  # pixels per segment-sum chunk


class OctreeTables(NamedTuple):
    """Device-resident quantizer constants (see geometry.OctreeGeometry)."""

    centers: jnp.ndarray      # (C, 3) f32 cell centers (h, s, v)
    s_v_f32: jnp.ndarray      # (C,) f32 center s*v as C computes it
    dist_ranks: jnp.ndarray   # (C, C) int32 dense rank of exact distances

    @classmethod
    def for_config(cls, cfg: ReportConfig) -> "OctreeTables":
        geom = octree_geometry(cfg)
        return cls(
            centers=jnp.asarray(geom.centers, dtype=jnp.float32),
            s_v_f32=jnp.asarray(geom.s_v_f32),
            dist_ranks=jnp.asarray(geom.dist_ranks),
        )


class PaletteResult(NamedTuple):
    """Fixed-shape palette: first n_valid rows are real entries, in the
    reference's valid_parents (saliency) order."""

    hsv: jnp.ndarray          # (C, 3) f32 average H, S, V per palette slot
    percentages: jnp.ndarray  # (C,) f32 fraction of image pixels
    n_valid: jnp.ndarray      # () int32 number of real palette entries
    parent_ids: jnp.ndarray   # (C,) int32 cell id backing each slot


def assign_cells(h: jnp.ndarray, s: jnp.ndarray, v: jnp.ndarray,
                 cfg: ReportConfig) -> jnp.ndarray:
    """Per-pixel octree cell id (reference src/color_quantization.c:127-145)."""
    black = cfg.black_thresh
    gray = cfg.gray_thresh
    lv = cfg.cell_Lv
    ls = cfg.cell_Ls
    lh = cfg.cell_Lh
    vi = jnp.clip((v - black) / lv, 0, cfg.v_partitions - 1e-6).astype(jnp.int32)
    si = jnp.clip((s - gray) / ls, 0, cfg.s_partitions - 1e-6).astype(jnp.int32)
    hi = jnp.clip(h / lh, 0, cfg.h_partitions - 1e-6).astype(jnp.int32)
    color_id = (hi * cfg.s_partitions + si) * cfg.v_partitions + vi
    # Gray: the premature int cast in the reference (:136) zeroes the value
    # index, so every gray pixel goes to the first gray cell.
    out = jnp.where(
        v < black,
        cfg.black_id,
        jnp.where(s < gray, cfg.gray_start, color_id),
    )
    return out.astype(jnp.int32)


def cell_counts(cells: jnp.ndarray, num_cells: int) -> jnp.ndarray:
    """Pixel count per cell, int32 (exact integer adds in any order).

    Sentinel cells (== num_cells, padded pixels) land in the extra
    trailing bucket and are dropped."""
    flat = cells.reshape(-1)
    return jnp.zeros((num_cells + 1,), jnp.int32).at[
        jnp.minimum(flat, num_cells)].add(1)[:num_cells]


def saliency_f32(counts: jnp.ndarray, s_v_f32: jnp.ndarray,
                 cfg: ReportConfig) -> jnp.ndarray:
    """Float32 replica of the C saliency (src/color_quantization.c:588-595)."""
    qw = jnp.float32(cfg.quantity_weight)
    svw = jnp.float32(cfg.saturation_value_weight)
    return counts.astype(jnp.float32) * (qw + svw * s_v_f32) * jnp.float32(1000.0)


def margin_insertion_argsort(sal: jnp.ndarray) -> jnp.ndarray:
    """Exact emulation of custom_sort with comparator (int)(sal_b - sal_a).

    Insertion sort bubbles element i left while the element to its left
    satisfies sal[left] - sal[i] <= -1.0 (float32 subtraction, C truncation
    toward zero makes (int)x < 0 iff x <= -1).  The final position of element
    i is therefore just past the last prefix element (scanning right-to-left)
    that does NOT satisfy the margin condition — computable with one
    vectorized pass per outer step.  reference: src/utilities.c:132-153,
    src/color_quantization.c:601-611.

    Cost: O(C^2) work on C-1 *sequential* fori_loop steps — inherent to
    the comparator (non-transitive margin comparisons admit no parallel
    sorting network that reproduces insertion-sort order).  At the default
    C=112 this is ~12k vector-lane ops, invisible next to the per-pixel
    stages; at the largest legal config (h_partitions=360 -> C=2164) it is
    ~4.7M lane ops on 2163 dependent steps, still far below one 1080p
    pixel pass but the dominant *serial* chain in the program.
    """
    c = sal.shape[0]
    iota = jnp.arange(c, dtype=jnp.int32)

    def body(i, order):
        elem = order[i]
        sal_i = sal[elem]
        prefix_sal = sal[order]
        # margin[j]: element at position j would be bubbled past.
        margin = (prefix_sal - sal_i) <= jnp.float32(-1.0)
        blockers = (~margin) & (iota < i)
        last_blocker = jnp.max(jnp.where(blockers, iota, -1))
        pos = last_blocker + 1
        shifted = jnp.roll(order, 1)
        new_order = jnp.where(
            iota < pos, order,
            jnp.where(iota == pos, elem,
                      jnp.where(iota <= i, shifted, order)))
        return new_order
    return jax.lax.fori_loop(1, c, body, iota)


def select_valid_parents(counts: jnp.ndarray, order: jnp.ndarray,
                         total_pixels: int, cfg: ReportConfig):
    """Coverage-threshold parent selection (reference :174-203).

    Returns (n_valid int32 scalar, valid_mask_sorted (C,) bool).
    """
    goal = int(float(total_pixels) * cfg.coverage_thresh)  # C int cast
    cum = jnp.cumsum(counts[order])
    n_valid = jnp.argmax(cum >= goal).astype(jnp.int32) + 1
    c = counts.shape[0]
    valid_mask_sorted = jnp.arange(c) < n_valid
    return n_valid, valid_mask_sorted


def candidate_slots(assign: "ParentAssignment", num_cells: int,
                    q_pad: int) -> jnp.ndarray:
    """(C, q_pad) int32: each cell's parent-candidate slots in ascending
    valid order, sentinel ``num_cells`` in unused entries.

    A cell's candidates are exactly its row of ``assign.allowed`` — one
    entry for untied cells (their unique parent), the tied set otherwise
    — so first-minimum-distance over this list in ascending k IS the
    reference's tie rule (src/color_quantization.c:376-451) and
    degenerates to the unique parent when there is one candidate.
    ``q_pad`` (static, from geometry.max_tie_candidates) bounds the
    count: tied candidates share one distance-rank value, so no cell
    exceeds the largest equal-rank group."""
    c = num_cells
    iota_k = jnp.arange(c, dtype=jnp.int32)
    big = jnp.int32(1 << 30)
    score = jnp.where(assign.allowed, -iota_k[None, :], -big)  # (C, C)
    take = min(q_pad, c)
    vals, _ = jax.lax.top_k(score, take)                       # (C, take)
    cand_k = jnp.where(vals > -big, -vals, c)                  # ascending k
    if q_pad > take:
        cand_k = jnp.concatenate(
            [cand_k, jnp.full((c, q_pad - take), c, cand_k.dtype)], axis=1)
    return cand_k


class ParentAssignment(NamedTuple):
    """Replicable (counts-only) state of the parent-selection phase."""

    order: jnp.ndarray          # (C,) int32 saliency-sorted cell ids
    n_valid: jnp.ndarray        # () int32
    valid_sorted: jnp.ndarray   # (C,) bool over sorted slots
    parent_of_cell: jnp.ndarray  # (C,) int32 unique nearest parent per cell
    cell_tied: jnp.ndarray      # (C,) bool: per-pixel tie-break required
    allowed: jnp.ndarray        # (C, C) bool: tied parents per cell, in
    #                             valid (saliency) order


def parent_assignment(counts: jnp.ndarray, total_pixels: int,
                      cfg: ReportConfig, tables: OctreeTables)\
        -> ParentAssignment:
    """Phases 3-5: saliency sort, coverage selection, nearest-parent map.

    Pure function of the (global) cell counts — in the spatially sharded
    path this runs replicated on every shard after a psum of the counts.
    """
    sal = saliency_f32(counts, tables.s_v_f32, cfg)
    order = margin_insertion_argsort(sal)          # valid_parents order
    return parent_assignment_from_order(counts, order, total_pixels, cfg,
                                        tables)


def parent_assignment_from_order(counts: jnp.ndarray, order: jnp.ndarray,
                                 total_pixels: int, cfg: ReportConfig,
                                 tables: OctreeTables) -> ParentAssignment:
    """Coverage selection + nearest-parent map, given the saliency order
    (so a batched caller can vmap the sort separately)."""
    c = cfg.num_cells
    n_valid, valid_sorted = select_valid_parents(counts, order,
                                                 total_pixels, cfg)

    # is_valid[cell] via positions: pos_in_order[order[k]] = k.
    pos_in_order = jnp.zeros((c,), jnp.int32).at[order].set(
        jnp.arange(c, dtype=jnp.int32))
    is_valid = pos_in_order < n_valid             # (C,) bool per cell id

    # Nearest valid parent per cell using exact distance ranks.  Column k of
    # rank_by_k holds rank[cell, order[k]]; invalid k masked to +inf-rank.
    rank_by_k = tables.dist_ranks[:, order]       # (C, C) int32
    big = jnp.int32(2**30)
    masked_ranks = jnp.where(valid_sorted[None, :], rank_by_k, big)
    min_rank = jnp.min(masked_ranks, axis=1)      # (C,)
    is_min = masked_ranks == min_rank[:, None]    # (C, C) in valid order
    num_mins = jnp.sum(is_min & valid_sorted[None, :], axis=1)
    first_min_k = jnp.argmax(is_min, axis=1)      # first in valid order (C:376-391)
    unique_parent = order[first_min_k]            # (C,)
    parent_of_cell = jnp.where(is_valid, jnp.arange(c, dtype=jnp.int32),
                               unique_parent)
    cell_tied = (~is_valid) & (num_mins > 1)      # triggers per-pixel branch
    allowed = is_min & valid_sorted[None, :]      # (C, C)
    return ParentAssignment(order=order, n_valid=n_valid,
                            valid_sorted=valid_sorted,
                            parent_of_cell=parent_of_cell,
                            cell_tied=cell_tied, allowed=allowed)


def palette_pixel_sums(h: jnp.ndarray, s: jnp.ndarray, v: jnp.ndarray,
                       cells: jnp.ndarray, assign: ParentAssignment,
                       cfg: ReportConfig, tables: OctreeTables,
                       q_pad: int = None) -> jnp.ndarray:
    """Per-pixel parent resolution + palette sums: (C, 4) f32 of
    [sum wrapped-hue, sum s, sum v, count] per parent cell id.

    Local to a shard; partial sums combine with psum (exact per-bin adds).
    ``q_pad`` narrows the candidate width (default: the config's static
    worst case); palette_q_tiers passes 8 — or 1, the pure parent-lookup
    pass — when its batch-level predicate proves no populated cell has
    more candidates (results are identical then: candidates past the
    real count are sentinels).
    """
    c = cfg.num_cells
    hf = h.reshape(-1)
    sf = s.reshape(-1)
    vf = v.reshape(-1)
    cells = cells.reshape(-1)
    order = assign.order
    centers_by_k = tables.centers[order]          # (C, 3) in valid order
    offsets = 180.0 - tables.centers[:, 0]        # (C,) per parent cell id
    # Candidate-LUT tie-break: gather each pixel's <= q_pad candidates
    # instead of scoring all C parents — the (chunk, C) distance matrix was the XLA path's
    # dominant cost (~1300 flops/px at C=112 vs ~100 at q_pad=8).  The
    # selected parent is identical: candidates are the allowed set in
    # ascending valid order, argmin takes the first minimum, and for
    # untied cells the single candidate IS parent_of_cell.
    if q_pad is None:
        q_pad = _q_full(cfg)
    cand_k = candidate_slots(assign, c, q_pad)     # (C, q_pad), sentinel c

    p = hf.shape[0]
    pad = (-p) % _CHUNK
    if pad:
        hf = jnp.concatenate([hf, jnp.zeros((pad,), hf.dtype)])
        sf = jnp.concatenate([sf, jnp.zeros((pad,), sf.dtype)])
        vf = jnp.concatenate([vf, jnp.zeros((pad,), vf.dtype)])
        cells = jnp.concatenate([cells, jnp.full((pad,), c, jnp.int32)])
    n_chunks = hf.shape[0] // _CHUNK

    # Per-cell parent for the q_pad == 1 tier: when no populated cell is
    # tied, every pixel's parent is a pure cell lookup — no distances.
    parent_of_slot0 = order[jnp.minimum(cand_k[:, 0], c - 1)]    # (C,)

    def body(acc, chunk):
        hc, sc, vc, cellc = chunk
        in_image = cellc < c
        cell_safe = jnp.minimum(cellc, c - 1)
        if q_pad == 1:
            parent = parent_of_slot0[cell_safe]
        else:
            cand_p = cand_k[cell_safe]                      # (chunk, q_pad)
            ctr = centers_by_k[jnp.minimum(cand_p, c - 1)]  # (chunk, q, 3)
            hd = jnp.abs(hc[:, None] - ctr[..., 0])
            hd = jnp.where(hd > 180.0, 360.0 - hd,
                           hd) * jnp.float32(1.0 / 360.0)
            sd = sc[:, None] - ctr[..., 1]
            vd = vc[:, None] - ctr[..., 2]
            d = hd * hd + sd * sd + vd * vd
            d_masked = jnp.where(cand_p < c, d, jnp.float32(np.inf))
            sel = jnp.argmin(d_masked, axis=1)          # first min = tie rule
            slot = jnp.take_along_axis(cand_p, sel[:, None], axis=1)[:, 0]
            parent = order[jnp.minimum(slot, c - 1)]
        off = offsets[parent]
        temp = hc + off
        temp = jnp.where(temp > 360.0, temp - 360.0,
                         jnp.where(temp < 0.0, temp + 360.0, temp))
        vals = jnp.stack([temp, sc, vc], axis=1)        # (chunk, 3)
        seg = jnp.where(in_image, parent, c)
        return acc + _bucket_sums(vals, seg, c), None

    init = jnp.zeros((c, 4), jnp.float32)
    sums, _ = jax.lax.scan(
        body, init,
        (hf.reshape(n_chunks, _CHUNK), sf.reshape(n_chunks, _CHUNK),
         vf.reshape(n_chunks, _CHUNK), cells.reshape(n_chunks, _CHUNK)))
    return sums


def _bucket_sums(vals: jnp.ndarray, seg: jnp.ndarray,
                 num_segments: int) -> jnp.ndarray:
    """(num_segments, 4) f32 [sum hue, sum s, sum v, count] of the rows of
    ``vals`` (P, 3) by segment id; rows with an id out of range drop out.

    A masked sum over every bucket (O(P * num_segments) work, fused by
    XLA into one reduction) instead of a scatter-add: XLA reduces in a
    fixed order, so the sums are the same bits on every call, where the
    GPU's f32 scatter-add runs on float atomics and changes the last bits
    from call to call."""
    vals = jnp.concatenate([vals, jnp.ones_like(vals[:, :1])], axis=1)
    hit = seg[:, None] == jnp.arange(num_segments, dtype=seg.dtype)[None, :]
    return jnp.sum(jnp.where(hit[:, :, None], vals[:, None, :], 0.0), axis=0)


def palette_finalize(sums: jnp.ndarray, assign: ParentAssignment,
                     total_pixels: int, tables: OctreeTables)\
        -> PaletteResult:
    """Palette averages in valid order (reference :510-576)."""
    order = assign.order
    per_parent = sums[order]                      # (C, 4) slot k <- order[k]
    offsets = 180.0 - tables.centers[:, 0]
    n_k = per_parent[:, 3]
    n_safe = jnp.maximum(n_k, 1.0)
    h_avg = per_parent[:, 0] / n_safe - offsets[order]
    h_avg = jnp.where(h_avg < 0.0, h_avg + 360.0,
                      jnp.where(h_avg > 360.0, h_avg - 360.0, h_avg))
    s_avg = per_parent[:, 1] / n_safe
    v_avg = per_parent[:, 2] / n_safe
    pct = n_k / jnp.float32(total_pixels)

    live = assign.valid_sorted
    hsv = jnp.where(live[:, None],
                    jnp.stack([h_avg, s_avg, v_avg], axis=1), 0.0)
    pct = jnp.where(live, pct, 0.0)
    return PaletteResult(hsv=hsv, percentages=pct, n_valid=assign.n_valid,
                         parent_ids=jnp.where(live, order, -1))


def color_palette(h: jnp.ndarray, s: jnp.ndarray, v: jnp.ndarray,
                  cfg: ReportConfig, tables: OctreeTables) -> PaletteResult:
    """Full quantization pipeline on the (possibly downsampled) HSV image."""
    total_pixels = int(np.prod(h.shape))
    cells = assign_cells(h, s, v, cfg).reshape(-1)
    counts = cell_counts(cells, cfg.num_cells)
    assign = parent_assignment(counts, total_pixels, cfg, tables)
    sums = palette_pixel_sums(h, s, v, cells, assign, cfg, tables)
    return palette_finalize(sums, assign, total_pixels, tables)


def color_palette_batched(h: jnp.ndarray, s: jnp.ndarray, v: jnp.ndarray,
                          cfg: ReportConfig, tables: OctreeTables)\
        -> PaletteResult:
    """Batched quantization: (B, H, W) HSV planes -> batched PaletteResult."""
    total_pixels = int(np.prod(h.shape[1:]))
    b = h.shape[0]
    c = cfg.num_cells
    cells = jax.vmap(lambda a, bb, cc: assign_cells(a, bb, cc, cfg))(h, s, v)
    cells = cells.reshape(b, -1)
    counts = jax.vmap(lambda x: cell_counts(x, c))(cells)
    sal = jax.vmap(lambda x: saliency_f32(x, tables.s_v_f32, cfg))(counts)
    order = jax.vmap(margin_insertion_argsort)(sal)
    assign = jax.vmap(
        lambda cnt, o: parent_assignment_from_order(cnt, o, total_pixels,
                                                    cfg, tables)
    )(counts, order)
    sums = palette_q_tiers(h, s, v, cells, assign, counts, cfg, tables)
    return jax.vmap(
        lambda sm, a: palette_finalize(sm, a, total_pixels, tables)
    )(sums, assign)


def _q_full(cfg: ReportConfig) -> int:
    """The config's static worst-case candidate width, a multiple of 8."""
    return max(8, -(-octree_geometry(cfg).max_tie_candidates // 8) * 8)


def palette_tier(assign: ParentAssignment, counts: jnp.ndarray,
                 cfg: ReportConfig) -> jnp.ndarray:
    """The tier palette_q_tiers takes: 0 (q=1: no populated cell is tied),
    1 (q=8) or 2 (q_full), from the most tie candidates any populated
    cell has across everything passed in (one image, or a batch with a
    leading axis)."""
    ncand = jnp.sum(assign.allowed, axis=-1)
    q_needed = jnp.max(jnp.where(counts > 0, ncand, 0))
    return ((q_needed > 1).astype(jnp.int32)
            + (q_needed > min(8, _q_full(cfg))).astype(jnp.int32))


def palette_q_tiers(h: jnp.ndarray, s: jnp.ndarray, v: jnp.ndarray,
                    cells: jnp.ndarray, assign: ParentAssignment,
                    counts: jnp.ndarray, cfg: ReportConfig,
                    tables: OctreeTables) -> jnp.ndarray:
    """Batched pixel pass with the scalar q=1/8/full width switch.

    q=1 when no populated cell is tied (most real photos —
    the pass is a pure per-cell parent lookup, zero distance math), q=8
    for the typical tied case (~q_full/8 x less distance + gather work
    than the static worst case), q_full otherwise.  Identical results on
    the taken branch (extra candidate slots are sentinels for every
    populated cell; pinned by tests).

    The batch rides the LEADING axis of every operand — callers must not
    vmap over images (that would batch the predicate and execute every
    tier; the dp-spatial body defers to after its vmap for exactly this
    reason, parallel/spatial.DeferredPalette).  Returns (B, C, 4) local
    sums; sharded callers psum them."""
    q_full = _q_full(cfg)

    def run(qp):
        def body(_):
            return jax.vmap(
                lambda hh, ss, vv, cc2, a: palette_pixel_sums(
                    hh, ss, vv, cc2, a, cfg, tables, q_pad=qp)
            )(h, s, v, cells, assign)
        return body

    return jax.lax.switch(palette_tier(assign, counts, cfg),
                          [run(1), run(min(8, q_full)), run(q_full)], None)
