"""Float64 numpy emulation of the PhotoHive_DSP C reference.

The reference's FFTW-linked shared library cannot load in this environment,
so parity goldens are re-derived numerically from the C sources (cited per
function below), float64 end to end, including the reference's intentional
quirks:

  * 0.999999 S/V clamps (src/image_processing.c:8-9);
  * the decimation row-stride quirk (src/image_processing.c:351-363);
  * integer-division cell sizes, the premature int cast that collapses all
    gray pixels into the first gray cell (src/color_quantization.c:136);
  * float32 saliency + the truncating margin comparator driving an insertion
    sort (src/color_quantization.c:588-611, src/utilities.c:132-153);
  * the truncated PI constant and integer-division radius bin sizing in the
    polar map (src/blur_profile.c:10,61,94) and the Newton integer sqrt
    (src/utilities.c:43-52);
  * the trailing (not centered) circular 5-tap smoother
    (src/filtering.c:12-24).

Undefined behavior is replaced by the evident intent, as documented:
get_distance_pixel_to_parent (src/color_quantization.c:303-311) is missing
its return statement; we use the distance value the function body computes.

This module is test-only and deliberately scalar/slow where faithfulness is
easier to audit than speed.
"""

from __future__ import annotations

import numpy as np

REFERENCE_PI = 3.14159265
MAX_SV = 0.999999


# ---------------------------------------------------------------------------
# colorspace + stats
# ---------------------------------------------------------------------------

def rgb2hsv(r, g, b, dtype=np.float64):
    """src/image_processing.c:372-417 (vectorized, float64; with
    ``dtype=np.float32`` every step rounds to float32 instead)."""
    r = np.asarray(r, dtype)
    g = np.asarray(g, dtype)
    b = np.asarray(b, dtype)
    mx = np.maximum(np.maximum(r, g), b)
    mn = np.minimum(np.minimum(r, g), b)
    delta = mx - mn
    safe = np.where(delta == 0, 1.0, delta)
    h = np.where(
        delta == 0, 0.0,
        np.where(mx == r, 60.0 * ((g - b) / safe),
                 np.where(mx == g, 60.0 * (2.0 + (b - r) / safe),
                          60.0 * (4.0 + (r - g) / safe))))
    h = np.where(h < 0, h + 360.0, h)
    h = np.where(h > 360, h - 360.0, h)
    v = np.where(mx == 1.0, MAX_SV, mx)
    s = np.where(mx == 0, 0.0,
                 np.where(delta == mx, MAX_SV,
                          delta / np.where(mx == 0, 1.0, mx)))
    return h, s, v


def rgb2pgm(r, g, b):
    """src/image_processing.c:505-512."""
    return 0.299 * np.asarray(r, np.float64) + 0.587 * g + 0.114 * b


def downsample_rgb(rgb, n):
    """src/image_processing.c:344-366 — row stride (n-1), column stride n."""
    if n <= 1:
        return rgb
    _, h, w = rgb.shape
    rows = np.arange(h // n) * (n - 1)
    cols = np.arange(w // n) * n
    return rgb[:, rows][:, :, cols]


def rgb_statistics(r, g, b):
    """src/image_processing.c:543-553: [Br,Bg,Bb,Cr,Cg,Cb]."""
    out = []
    for ch in (r, g, b):
        out.append(np.mean(np.asarray(ch, np.float64)))
    for ch in (r, g, b):
        ch = np.asarray(ch, np.float64)
        out.append(np.sqrt(np.mean((ch - np.mean(ch)) ** 2)))
    return np.array(out)


# ---------------------------------------------------------------------------
# filtering + sharpness
# ---------------------------------------------------------------------------

def laplacian_filter(x):
    """src/filtering.c:40-50,81-107: zero-padded 3x3 (-1 ring, +8 center)."""
    x = np.asarray(x, np.float64)
    p = np.pad(x, 1)
    neigh = (p[:-2, :-2] + p[:-2, 1:-1] + p[:-2, 2:]
             + p[1:-1, :-2] + p[1:-1, 2:]
             + p[2:, :-2] + p[2:, 1:-1] + p[2:, 2:])
    return 8.0 * x - neigh


def variance_sharpness(pgm, boxes):
    """src/filtering.c:151-183. boxes: list of (top, bottom, left, right)."""
    out = []
    for top, bottom, left, right in boxes:
        crop = pgm[top:bottom, left:right]
        resp = laplacian_filter(crop)
        mean = resp.mean()
        var = ((resp - mean) ** 2).mean()
        out.append(var / mean)
    return np.array(out)


def trailing_circular_box(x, size):
    """src/filtering.c:12-24."""
    x = np.asarray(x, np.float64)
    acc = np.zeros_like(x)
    n = len(x)
    for j in range(size):
        acc += np.roll(x, j)
    return acc / size


# ---------------------------------------------------------------------------
# FFT + blur profile
# ---------------------------------------------------------------------------

def newton_int_sqrt(val):
    """src/utilities.c:43-52 (scalar)."""
    if val == 0:
        return 0
    x = val
    while True:
        s = 0.5 * (x + val / x)
        if abs(s - x) < 1:
            return int(s)
        x = s


def magnitude_fft(pgm):
    """src/fft_processing.c:18-63: |rfft2|^2 over half spectrum."""
    spec = np.fft.rfft2(np.asarray(pgm, np.float64))
    return np.abs(spec) ** 2


def normalize_fft(mag):
    """src/fft_processing.c:173-213."""
    mx = mag.max()
    g_s = 1.0 / (2.0 * np.log(np.sqrt(mx) + 1.0))
    return np.where(mag < 1.0, 0.0, np.log(np.where(mag < 1, 1, mag)) * g_s)


def polar_map(height, width):
    """src/blur_profile.c:427-458 with the bottom-half mirror quirk."""
    fft_w = width // 2 + 1
    r_sq = np.empty((height, fft_w), np.int64)
    phi = np.empty((height, fft_w), np.float64)
    half = height // 2
    bound = half + 1 if height % 2 == 1 else half
    x = np.arange(fft_w, dtype=np.float64)
    for y in range(bound):
        p = np.arctan2(float(y), x)
        rs = (x.astype(np.int64) ** 2 + y * y).astype(np.int64)
        phi[y] = -p
        r_sq[y] = rs
        phi[height - 1 - y] = p
        r_sq[height - 1 - y] = rs
    return r_sq, phi


def blur_profile(fft_norm, num_radius_bins, num_angle_bins):
    """src/blur_profile.c:34-126 (scatter loops vectorized, same math)."""
    h, fft_w = fft_norm.shape
    # Reconstruct spatial width from the half spectrum is ambiguous; callers
    # pass the full map instead.
    raise NotImplementedError("use blur_profile_from_shape")


def blur_profile_from_shape(fft_norm, height, width,
                            num_radius_bins, num_angle_bins):
    fft_w = width // 2 + 1
    assert fft_norm.shape == (height, fft_w)
    r_sq, phi = polar_map(height, width)
    a, r = num_angle_bins, num_radius_bins
    phi_bin = ((phi + REFERENCE_PI * 0.5) / REFERENCE_PI * (a - 1)).astype(np.int64)
    phi_bin = np.clip(phi_bin, 0, a - 1)
    rbss = (fft_w * fft_w + (height * height) // 4) // (r * r)
    ratio = r_sq.astype(np.float64) / float(rbss)
    r_bin = np.empty(ratio.shape, np.int64)
    flat = ratio.ravel()
    rb = np.empty(flat.shape, np.int64)
    # vectorized newton iteration
    val = flat.copy()
    x = np.where(val == 0, 1.0, val)
    out = np.zeros(val.shape, np.int64)
    active = val != 0
    while active.any():
        s = 0.5 * (x + val / x)
        done = active & (np.abs(s - x) < 1.0)
        out[done] = s[done].astype(np.int64)
        active &= ~done
        x = np.where(active, s, x)
    rb = out
    rb = np.where(rb == r, r - 1, rb)
    rb = np.clip(rb, 0, r - 1)
    r_bin = rb.reshape(ratio.shape)

    flat_bin = (phi_bin * r + r_bin).ravel()
    sums = np.bincount(flat_bin, weights=fft_norm.ravel(), minlength=a * r)
    counts = np.bincount(flat_bin, minlength=a * r)
    bins = np.where(counts > 0, sums / np.maximum(counts, 1), 0.0)
    return bins.reshape(a, r)


def vectorize_blur_profile(bins, error_thresh, mag_thresh, cutoff_denom):
    """src/blur_profile.c:324-416 — scalar, faithful control flow."""
    a, r = bins.shape
    radius_cutoff = r // cutoff_denom
    tot = bins[:, :radius_cutoff].sum(axis=1)
    avg = tot.sum() / a
    smooth = trailing_circular_box(tot, 5)

    maxima = []
    if smooth[0] > smooth[a - 1] and smooth[0] > smooth[1]:
        if smooth[0] > avg * error_thresh and len(maxima) < 10:
            maxima.append(0)
    for i in range(1, a - 1):
        if smooth[i] > smooth[i - 1] and smooth[i] > smooth[i + 1]:
            if smooth[i] > avg * error_thresh and len(maxima) < 10:
                maxima.append(i)
    if smooth[a - 1] > smooth[a - 2] and smooth[a - 1] > smooth[0]:
        if smooth[a - 1] > avg * error_thresh and len(maxima) < 10:
            maxima.append(a - 1)

    vectors = [(0, 0.0)] * 10
    for i, ang in enumerate(maxima):
        angle_idx = (ang + a // 2) % a
        cur = bins[angle_idx]
        blur_avg = cur[:radius_cutoff].sum()
        if blur_avg > avg:
            continue
        cur_max_radius = r
        for j in range(r):
            if cur[j] < mag_thresh:
                cur_max_radius = j
                break
        mag = np.float32(cur_max_radius) / np.float32(r)
        angle = int(180 * (np.float32(angle_idx) / np.float32(a)) - 90)
        vectors[i] = (angle, float(mag))
    return vectors


# ---------------------------------------------------------------------------
# color quantization
# ---------------------------------------------------------------------------

class GoldenOctree:
    """Faithful emulation of the octree pipeline on float64 HSV arrays."""

    def __init__(self, h_parts=18, s_parts=2, v_parts=3,
                 black_thresh=0.1, gray_thresh=0.1, coverage_thresh=0.95,
                 quantity_weight=0.1, saturation_value_weight=0.9):
        self.h_parts, self.s_parts, self.v_parts = h_parts, s_parts, v_parts
        self.num_grays = v_parts
        self.black = black_thresh
        self.gray = gray_thresh
        self.coverage = coverage_thresh
        self.qw = np.float32(quantity_weight)
        self.svw = np.float32(saturation_value_weight)
        self.total = h_parts * s_parts * v_parts + self.num_grays + 1
        self.gray_start = self.total - (self.num_grays + 1)
        self.black_id = self.total - 1
        self.lh = float(360 // h_parts)
        self.ls = (1.0 - gray_thresh) / s_parts
        self.lv = (1.0 - black_thresh) / v_parts
        # Cell centers (src/color_quantization.c:57-98).
        self.centers = np.zeros((self.total, 3))
        half_h = self.lh / 2
        s_offs = self.ls / 2 + gray_thresh
        v_offs = self.lv / 2 + black_thresh
        for hh in range(h_parts):
            for ss in range(s_parts):
                for vv in range(v_parts):
                    i = hh * s_parts * v_parts + ss * v_parts + vv
                    self.centers[i] = (hh * self.lh + half_h,
                                       ss * self.ls + s_offs,
                                       vv * self.lv + v_offs)
        l_gray = (1.0 - black_thresh) / self.num_grays
        base = h_parts * s_parts * v_parts
        for j in range(self.num_grays):
            self.centers[base + j] = (0.0, 0.0, l_gray * j + v_offs)
        self.centers[self.black_id] = (0.0, 0.0, 0.0)

    def assign(self, h, s, v):
        """arm_octree cell ids (src/color_quantization.c:127-145)."""
        vi = ((v - self.black) / self.lv).astype(np.int64)
        si = ((s - self.gray) / self.ls).astype(np.int64)
        hi = (h / self.lh).astype(np.int64)
        color = (hi * self.s_parts + si) * self.v_parts + vi
        # premature int cast (:136): (int)(v-black) == 0 for v in [black, 1)
        return np.where(v < self.black, self.black_id,
                        np.where(s < self.gray, self.gray_start, color))

    def saliency(self, counts):
        """float32 saliency (src/color_quantization.c:588-595)."""
        s_v = (self.centers[:, 1] * self.centers[:, 2]).astype(np.float32)
        return (counts.astype(np.float32)
                * (self.qw + self.svw * s_v)) * np.float32(1000.0)

    def sort_ids(self, counts):
        """custom_sort insertion sort with the truncating comparator."""
        sal = self.saliency(counts)
        order = list(range(self.total))
        for i in range(1, self.total):
            j = i
            while j > 0:
                diff = np.float32(sal[order[j - 1]]) - np.float32(sal[order[j]])
                if int(np.float32(diff)) < 0:
                    order[j - 1], order[j] = order[j], order[j - 1]
                    j -= 1
                else:
                    break
        return order

    def node_distance(self, c, p):
        """src/color_quantization.c:253-288 (float64)."""
        gc, gp = self.centers[c], self.centers[p]
        c_color = c < self.gray_start
        p_color = p < self.gray_start
        c_gray = self.gray_start <= c < self.black_id
        p_gray = self.gray_start <= p < self.black_id
        if c_color and p_color:
            hd = abs(gc[0] - gp[0])
            if hd > 180:
                hd = 360 - hd
            hd *= 1.0 / 360.0
            sd = gc[1] - gp[1]
            vd = gc[2] - gp[2]
            return hd * hd + sd * sd + vd * vd
        if (c_gray and p_color) or (p_gray and c_color):
            sd = gc[1] - gp[1]
            vd = gc[2] - gp[2]
            return sd * sd + vd * vd
        vd = gc[2] - gp[2]
        return vd * vd

    def pixel_distance(self, ph, ps, pv, parent):
        """Intended body of get_distance_pixel_to_parent (:303-311)."""
        gp = self.centers[parent]
        hd = abs(ph - gp[0])
        if hd > 180:
            hd = 360 - hd
        hd *= 1.0 / 360.0
        sd = ps - gp[1]
        vd = pv - gp[2]
        return hd * hd + sd * sd + vd * vd

    def palette(self, h, s, v):
        """Full get_color_palette (:652-684).

        Returns (averages (N,3), percentages (N,), parent_ids (N,)).
        """
        h = np.asarray(h, np.float64).ravel()
        s = np.asarray(s, np.float64).ravel()
        v = np.asarray(v, np.float64).ravel()
        total_pixels = h.size
        cells = self.assign(h, s, v)
        counts = np.bincount(cells, minlength=self.total)

        order = self.sort_ids(counts)
        goal = int(float(total_pixels) * self.coverage)
        n_valid = None
        acc = goal
        for i, cid in enumerate(order):
            acc -= counts[cid]
            if acc <= 0:
                n_valid = i + 1
                break
        assert n_valid is not None
        valid = order[:n_valid]
        valid_set = set(valid)

        # group_irregular_pixels (:342-479)
        parent_pixels = {p: [np.where(cells == p)[0]] for p in valid}
        for c in range(self.total):
            if counts[c] == 0 or c in valid_set:
                continue
            dists = [self.node_distance(c, p) for p in valid]
            dmin = min(dists)
            tied = [p for p, d in zip(valid, dists) if d == dmin]
            members = np.where(cells == c)[0]
            if len(tied) == 1:
                parent_pixels[tied[0]].append(members)
            else:
                # Documented deviation (IMPLEMENTATION_STATUS Known gaps):
                # the C multi-tie branch never advances cur_groups[parent]
                # (:436-446), so once a tied parent's tail node fills,
                # every further pixel orphans its predecessor and only the
                # LAST overflow pixel reaches calculate_avg_hsv.  We (and
                # the JAX build) keep every pixel's contribution.
                for idx in members:
                    best, bestd = None, np.inf
                    for p in tied:
                        d = self.pixel_distance(h[idx], s[idx], v[idx], p)
                        if d < bestd:
                            bestd, best = d, p
                    parent_pixels[best].append(np.array([idx]))

        # calculate_avg_hsv (:510-576)
        averages = np.zeros((n_valid, 3))
        percentages = np.zeros(n_valid)
        for k, p in enumerate(valid):
            idxs = np.concatenate(parent_pixels[p]) if parent_pixels[p] \
                else np.array([], np.int64)
            npix = idxs.size
            offset = 180.0 - self.centers[p, 0]
            temp = h[idxs] + offset
            temp = np.where(temp > 360.0, temp - 360.0,
                            np.where(temp < 0.0, temp + 360.0, temp))
            h_avg = temp.sum() / npix - offset
            if h_avg < 0:
                h_avg += 360.0
            elif h_avg > 360.0:
                h_avg -= 360.0
            averages[k] = (h_avg, s[idxs].sum() / npix, v[idxs].sum() / npix)
            percentages[k] = npix / total_pixels
        return averages, percentages, np.array(valid)


# ---------------------------------------------------------------------------
# full report
# ---------------------------------------------------------------------------

def full_report(rgb, boxes=None, h_partitions=18, s_partitions=2,
                v_partitions=3, black_thresh=0.1, gray_thresh=0.1,
                coverage_thresh=0.95, downsample_rate=1,
                radius_partitions=40, angle_partitions=72,
                quantity_weight=0.1, saturation_value_weight=0.9,
                fft_streak_thresh=1.20, magnitude_thresh=0.3,
                blur_cutoff_ratio_denom=2):
    """Golden full report; rgb is (3, H, W) float64 in [0, 1].

    Mirrors src/interface.c:20-94 stage order and data routing.
    """
    _, height, width = rgb.shape
    down = downsample_rgb(rgb, downsample_rate)
    h, s, v = rgb2hsv(down[0], down[1], down[2])
    pgm = rgb2pgm(rgb[0], rgb[1], rgb[2])
    stats = rgb_statistics(rgb[0], rgb[1], rgb[2])
    s_bar = np.mean(s)
    oct_ = GoldenOctree(h_partitions, s_partitions, v_partitions,
                        black_thresh, gray_thresh, coverage_thresh,
                        quantity_weight, saturation_value_weight)
    averages, percentages, parent_ids = oct_.palette(h, s, v)
    sharp = variance_sharpness(pgm, boxes) if boxes else np.array([])
    avg = (stats[0] + stats[1] + stats[2]) / 3.0
    mag = normalize_fft(magnitude_fft(pgm - avg))
    bins = blur_profile_from_shape(mag, height, width,
                                   radius_partitions, angle_partitions)
    vectors = vectorize_blur_profile(bins, fft_streak_thresh,
                                     magnitude_thresh,
                                     blur_cutoff_ratio_denom)
    return dict(rgb_stats=stats, average_saturation=s_bar,
                palette_hsv=averages, palette_pct=percentages,
                palette_ids=parent_ids, sharpness=sharp, blur_bins=bins,
                blur_vectors=vectors)
