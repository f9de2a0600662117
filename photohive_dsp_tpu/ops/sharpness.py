"""Laplacian-variance sharpness over salient-character crop boxes.

reference: src/filtering.c:151-183 — for each crop box, crop the grayscale
image, run the zero-padded 3x3 Laplacian over the *crop*, and report
variance(response)/mean(response) ("scale-invariant" sharpness).

Static-shape formulation: instead of dynamic-shaped crops (which break XLA's
static-shape compilation), each box is handled as a masked full-image pass:
zero the image outside the box, run the Laplacian everywhere, and reduce with
the box mask.  Because the crop is zeroed outside its bounds, the stencil at
crop borders sees exactly the zero padding the reference's crop-then-filter
produces, so the response values inside the box match bit-for-bit in exact
arithmetic.  The ``MAX_CROP_BOXES``-slot box tensor is vmapped, giving a
fixed-shape (10,) output with a validity mask.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .filtering import laplacian_3x3

# Boxes under this many px in either dimension route to the exact masked
# two-pass formulation: the fast shared-response path assembles the crop's
# sum(resp^2) from terms ~1e3 larger than the tiny crop's variance, leaving
# ~1e-6 absolute f32 cancellation noise the per-pixel mean-subtracted pass
# does not have.  Shared with parallel/spatial._sharded_sharpness.
TINY_BOX_PX = 4


def _one_box_sharpness(pgm: jnp.ndarray, box: jnp.ndarray,
                       valid: jnp.ndarray) -> jnp.ndarray:
    """box = [top, bottom, left, right); returns var/mean of the response."""
    h, w = pgm.shape
    top, bottom, left, right = box[0], box[1], box[2], box[3]
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    inside = ((ys >= top) & (ys < bottom) & (xs >= left) & (xs < right))
    insf = inside.astype(pgm.dtype)
    resp = laplacian_3x3(pgm * insf)
    n = jnp.maximum((bottom - top) * (right - left), 1).astype(pgm.dtype)
    # Exact-in-algebra response sum (see _ring_weight_map): summing the
    # mixed-sign response over the whole crop cancels catastrophically in
    # f32 (the interior sums to ~0 through ~n large terms); the telescoped
    # ring-weighted sum of the *input* pixels is positive-weighted over
    # O(perimeter) terms, matching the reference's f64 mean to ~1e-7.
    wmap = _ring_weight_map(ys, xs, box) * insf
    mean = jnp.sum(pgm * wmap) / n
    var = jnp.sum(jnp.square(resp - mean) * insf) / n
    # var/mean unguarded, like the reference's double division
    # (src/filtering.c:174) and the f64 golden: an exactly-zero response
    # mean yields IEEE +/-inf (or NaN for a fully flat crop).
    return jnp.where(valid, var / mean, 0.0)


def _ring_weight_map(ys: jnp.ndarray, xs: jnp.ndarray,
                     box: jnp.ndarray) -> jnp.ndarray:
    """Weights W(y,x) with sum(resp_crop) == sum(pgm * W) over the crop.

    For the zero-padded crop Laplacian, sum_p resp(p) = sum_q x(q) *
    (8 - deg_in(q)) where deg_in(q) counts q's 8-neighbors inside the
    crop: every interior pixel contributes exactly zero, so the response
    sum telescopes onto the crop's 1-px border ring.  With rows_in(y) =
    |{y-1, y, y+1} ∩ [top, bottom)| and cols_in likewise, deg_in =
    rows_in*cols_in - 1, giving W = 9 - rows_in*cols_in (5 at corners, 3
    on edges, 0 inside; exact for every box shape including 1-px-thin)."""
    top, bottom, left, right = box[0], box[1], box[2], box[3]
    rows_in = ((ys - 1 >= top).astype(jnp.int32) + 1
               + (ys + 1 < bottom).astype(jnp.int32))
    cols_in = ((xs - 1 >= left).astype(jnp.int32) + 1
               + (xs + 1 < right).astype(jnp.int32))
    return (9 - rows_in * cols_in).astype(jnp.float32)


def variance_sharpness(pgm: jnp.ndarray, boxes: jnp.ndarray,
                       boxes_valid: jnp.ndarray) -> jnp.ndarray:
    """Sharpness per crop box.

    pgm:         (H, W) grayscale image (full resolution, pre-DC-removal —
                 the reference computes sharpness before remove_dc_bias
                 mutates the shared buffer, src/interface.c:73 vs :79).
    boxes:       (MAX_CROP_BOXES, 4) int32 [top, bottom, left, right).
    boxes_valid: (MAX_CROP_BOXES,) bool.
    Returns (MAX_CROP_BOXES,) f32, zeros in invalid slots.
    """
    return jax.vmap(_one_box_sharpness, in_axes=(None, 0, 0))(
        pgm, boxes, boxes_valid
    )


def _box_ring_terms(pgm_pad: jnp.ndarray, resp: jnp.ndarray,
                    box: jnp.ndarray):
    """Ring correction for one box: sum over the ring of 2*r*c + c^2 (the
    difference between the crop's sum(resp^2) and the shared response's).
    The response *mean* needs no correction term from here — it comes from
    the exact telescoped border-ring identity in the caller.

    The global Laplacian response differs from the crop-then-filter response
    only on the box's 1-px border ring, where the crop's zero padding
    removes the -1-tap neighbors outside the box:
    resp_crop(p) = resp_full(p) + corr(p) with
    corr(p) = sum of pgm over N8(p) outside the box.  corr splits disjointly
    into a vertical part (neighbor row outside; only rows top/bottom-1) and
    a horizontal part (neighbor row inside, column outside; only columns
    left/right-1); the four corner pixels carry both, hence the 2*cV*cH
    cross terms.  Exact for boxes at least 2 px in each dimension (the
    caller falls back below that)."""
    h, w = resp.shape
    t, b, l, r = box[0], box[1], box[2], box[3]
    xs = jnp.arange(w)
    ys = jnp.arange(h)

    # Vertical: pixels in rows t and b-1; outside neighbors are full rows
    # t-1 and b (padded coordinates shift by +1; image edges read zeros).
    row_above = jax.lax.dynamic_slice(pgm_pad, (t, 0), (1, w + 2))[0]
    row_below = jax.lax.dynamic_slice(pgm_pad, (b + 1, 0), (1, w + 2))[0]
    cv_t = row_above[:-2] + row_above[1:-1] + row_above[2:]      # (W,)
    cv_b = row_below[:-2] + row_below[1:-1] + row_below[2:]
    resp_t = jax.lax.dynamic_slice(resp, (t, 0), (1, w))[0]
    resp_b = jax.lax.dynamic_slice(resp, (jnp.maximum(b - 1, 0), 0),
                                   (1, w))[0]
    xin = (xs >= l) & (xs < r)
    sum_v = jnp.sum(jnp.where(
        xin, 2.0 * (resp_t * cv_t + resp_b * cv_b) + cv_t * cv_t
        + cv_b * cv_b, 0.0))

    # Horizontal: pixels in columns l and r-1; outside neighbors are the
    # columns l-1 and r restricted to rows inside the box.
    pad_t = jnp.pad(resp, ((1, 1), (1, 1)))
    col_left = jax.lax.dynamic_slice(pgm_pad, (0, l), (h + 2, 1))[:, 0]
    col_right = jax.lax.dynamic_slice(pgm_pad, (0, r + 1), (h + 2, 1))[:, 0]

    def ch_of(col):
        # ch(y) = col[y-1]*[y-1>=t] + col[y] + col[y+1]*[y+1<b], y in [t,b)
        mid = col[1:-1]
        up = jnp.where(ys - 1 >= t, col[:-2], 0.0)
        dn = jnp.where(ys + 1 < b, col[2:], 0.0)
        return up + mid + dn                                     # (H,)

    ch_l = ch_of(col_left)
    ch_r = ch_of(col_right)
    resp_l = jax.lax.dynamic_slice(pad_t, (1, l + 1), (h, 1))[:, 0]
    resp_r = jax.lax.dynamic_slice(
        pad_t, (1, jnp.maximum(r, 1)), (h, 1))[:, 0]
    yin = (ys >= t) & (ys < b)
    sum_h = jnp.sum(jnp.where(
        yin, 2.0 * (resp_l * ch_l + resp_r * ch_r) + ch_l * ch_l
        + ch_r * ch_r, 0.0))

    # Corner cross terms 2*cV*cH at the four ring intersections.
    def at(vec, i):
        return jax.lax.dynamic_slice(vec, (jnp.maximum(i, 0),), (1,))[0]

    cross = 2.0 * (at(cv_t, l) * at(ch_l, t) + at(cv_t, r - 1) * at(ch_r, t)
                   + at(cv_b, l) * at(ch_l, b - 1)
                   + at(cv_b, r - 1) * at(ch_r, b - 1))
    return sum_v + sum_h + cross


def variance_sharpness_batched(pgm: jnp.ndarray, boxes: jnp.ndarray,
                               boxes_valid: jnp.ndarray) -> jnp.ndarray:
    """Batched sharpness: (B, H, W) x (B, 10, 4) -> (B, 10).

    The throughput formulation: ONE shared Laplacian pass per image instead
    of one masked pass per box, per-box sums as separable row/column-mask
    GEMMs over the shared response (and its square), and the crop-boundary
    zero-padding reproduced exactly through ring corrections
    (_box_ring_terms).  Algebraically identical to the reference's
    crop-then-filter; the response mean uses the exact telescoped ring
    identity (see fast() below), so both paths track the float64 golden
    to ~1e-7 relative.  Falls back to the masked
    formulation (one whole-batch lax.cond) when any valid box is smaller
    than TINY_BOX_PX in either dimension (cancellation, see above)."""
    bsz, h, w = pgm.shape

    def fast(_):
        resp = jax.vmap(laplacian_3x3)(pgm)                      # (B, H, W)
        resp2 = resp * resp
        t, b = boxes[..., 0], boxes[..., 1]                      # (B, 10)
        l, r = boxes[..., 2], boxes[..., 3]
        hidx = jnp.arange(h)[None, None, :]
        widx = jnp.arange(w)[None, None, :]
        rowm = (hidx >= t[..., None]) & (hidx < b[..., None])
        colm = (widx >= l[..., None]) & (widx < r[..., None])
        rm = rowm.astype(pgm.dtype)
        cm = colm.astype(pgm.dtype)
        hi = jax.lax.Precision.HIGHEST

        def boxsum(a, row_mask, col_mask):
            per_row = jnp.einsum("bhw,bkw->bkh", a, col_mask, precision=hi)
            return jnp.einsum("bkh,bkh->bk", per_row, row_mask,
                              precision=hi)

        s2 = boxsum(resp2, rm, cm)
        pgm_pad = jnp.pad(pgm, ((0, 0), (1, 1), (1, 1)))
        ring = jax.vmap(lambda pp, rr, bx: jax.vmap(
            lambda one: _box_ring_terms(pp, rr, one))(bx))(pgm_pad, resp,
                                                           boxes)
        s2 = s2 + ring

        # Exact response sum via the telescoped border-ring identity
        # (_ring_weight_map): sum(resp_crop) = sum(pgm * (9 - rows_in *
        # cols_in)) over the box.  With alpha = 3 - rows_in and beta =
        # 3 - cols_in (nonzero only on border rows/cols), 9 - ab = 3*alpha
        # + 3*beta - alpha*beta — three separable positive-weighted GEMMs
        # over O(perimeter) effective terms, free of the O(area)
        # cancellation that made the f32 mean ~1e-2 inaccurate.
        alpha = rm * ((hidx - 1 < t[..., None]).astype(pgm.dtype)
                      + (hidx + 1 >= b[..., None]).astype(pgm.dtype))
        beta = cm * ((widx - 1 < l[..., None]).astype(pgm.dtype)
                     + (widx + 1 >= r[..., None]).astype(pgm.dtype))
        s1 = (3.0 * boxsum(pgm, alpha, cm) + 3.0 * boxsum(pgm, rm, beta)
              - boxsum(pgm, alpha, beta))

        n = jnp.maximum((b - t) * (r - l), 1).astype(pgm.dtype)
        mean = s1 / n
        var = s2 / n - mean * mean
        # Unguarded division like the reference (src/filtering.c:174):
        # a zero response mean yields IEEE inf/NaN, not a masked value.
        return jnp.where(boxes_valid, var / mean, 0.0)

    def masked(_):
        return jax.vmap(variance_sharpness)(pgm, boxes, boxes_valid)

    thin = boxes_valid & ((boxes[..., 1] - boxes[..., 0] < TINY_BOX_PX)
                          | (boxes[..., 3] - boxes[..., 2] < TINY_BOX_PX))

    def have_boxes(_):
        return jax.lax.cond(jnp.any(thin), masked, fast, None)

    # No valid box in the whole batch -> skip the stage entirely (the
    # reference does: sharpness costs ~3 us without boxes, README.md:69,
    # src/interface.c crop loop over zero boxes).  This is the common
    # bulk-corpus configuration; the Laplacian + box GEMMs are the
    # second-largest non-palette cost, all dead work then.
    return jax.lax.cond(jnp.any(boxes_valid), have_boxes,
                        lambda _: jnp.zeros(boxes_valid.shape, pgm.dtype),
                        None)
