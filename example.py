"""End-to-end usage example (this build's counterpart of the reference's
example.py): load an image, compute its report, save the visualizations,
and print the fixed-schema JSON.

    python example.py [image.{png,jpg,txt}]

With no argument a synthetic race-photo-like image is generated.
"""

from __future__ import annotations

import sys

import numpy as np

import photohive_dsp_tpu as ph
from photohive_dsp_tpu.utils.io import load_image


def synthetic_photo(height=720, width=1080):
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:height, 0:width].astype(np.float32)
    img = np.stack([
        120 + 70 * np.sin(x / 120) + rng.normal(0, 5, x.shape),
        110 + 60 * np.cos(y / 90) + rng.normal(0, 5, x.shape),
        100 + 40 * np.sin((x + y) / 150) + rng.normal(0, 5, x.shape),
    ], axis=-1)
    img[200:360, 300:520] = (210, 50, 40)    # "athlete" crop subject
    img[420:560, 600:780] = (40, 90, 200)
    return img.clip(0, 255).astype(np.uint8)


def main() -> None:
    if len(sys.argv) > 1:
        rgb = load_image(sys.argv[1])                  # (3, H, W) float32
        image = np.moveaxis((rgb * 255).astype(np.uint8), 0, -1)
    else:
        image = synthetic_photo()

    boxes = ph.set_bounding_boxes([
        dict(top=200, bottom=360, left=300, right=520),
        dict(top=420, bottom=560, left=600, right=780),
    ])

    report = ph.get_report(image, boxes)
    if report is None:
        sys.exit(1)

    print(f"palette: {report.color_palette.N} colors; "
          f"top 3: {report.color_palette.colors[:3]}")
    print(f"sharpness per box: {[round(s, 3) for s in report.sharpnesses]}")
    vectors = [(v.angle, round(v.magnitude, 3))
               for v in report.blur_vectors if v.magnitude]
    print(f"blur vectors: {vectors or 'none detected'}")

    report.generate_color_palette_image().save("palette.png")
    report.generate_blur_profile_image().save("blur_profile.png")
    report.generate_blur_direction_frequency_response().save(
        "frequency_response.png")
    report.generate_report_card(image=image, bounding_boxes=boxes).save(
        "report_card.png")
    print("wrote palette.png, blur_profile.png, frequency_response.png, "
          "report_card.png")
    print(report.to_json()[:400] + " ...")


if __name__ == "__main__":
    main()
