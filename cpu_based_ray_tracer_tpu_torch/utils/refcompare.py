"""Statistical comparison of renders against the reference's published
sample images (``$CRT_REFERENCE_DIR/Sample Images/``, the reference's
``README.md:79-107``); port of ``cpu_based_ray_tracer_tpu.utils.refcompare``,
numpy only: the same crops, grids and statistics.

The reference's images are full-application screenshots (ImGui title bar +
viewport + control panel), JPEG-compressed, sometimes at a free-flown camera
pose.  Pixel-exact comparison is therefore impossible; what IS comparable:

- for the fixed-pose stages (Monte Carlo Cornell, Denoiser Cornell, Whitted,
  NPPT) the *scene content* can be located in both images, cropped, reduced
  to an ``n x n`` grid of mean colors, and compared cell by cell — this
  checks framing, wall colors, light position, shading gradients and overall
  exposure all at once;
- for the free-flown mesh shots (``stanford_bunny.jpg``, ``utah_teapot.jpg``,
  ``bvh ray tracer.jpg``) only color statistics are meaningful (sky RGB,
  object grey level).

All functions take/return float RGB in [0, 1], shape (H, W, 3).
"""

from __future__ import annotations

import os

import numpy as np

# The reference checkout, read only from $CRT_REFERENCE_DIR (as the mesh
# scenes' assets); unset, no sample image is available.
REFERENCE_DIR = os.environ.get("CRT_REFERENCE_DIR")
SAMPLE_DIR = (os.path.join(REFERENCE_DIR, "Sample Images")
              if REFERENCE_DIR else None)


def sample_image_path(rel: str) -> str | None:
    """Absolute path of a reference sample image, or None if unavailable."""
    if SAMPLE_DIR is None:
        return None
    p = os.path.join(SAMPLE_DIR, rel)
    return p if os.path.isfile(p) else None


def load_rgb(path) -> np.ndarray:
    """Any image file -> float RGB (H, W, 3) in [0, 1] (PIL-backed)."""
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"), np.float32)
    return arr / 255.0


def box_filter(img: np.ndarray, k: int) -> np.ndarray:
    """Mean-pool by factor k (truncating ragged edges)."""
    h, w = img.shape[0] // k, img.shape[1] // k
    return img[:h * k, :w * k].reshape(h, k, w, k, -1).mean((1, 3))


def _occupancy_bbox(mask: np.ndarray, pool: int, frac: float
                    ) -> tuple[int, int, int, int]:
    """Bounding box over rows/cols whose matching-pixel count is at least
    ``frac`` of the best row/col — a bbox robust to small off-region matches
    (UI buttons, text, JPEG speckle) that a plain any-match bbox would
    swallow."""
    rsum, csum = mask.sum(1), mask.sum(0)
    rows = np.flatnonzero(rsum >= frac * rsum.max())
    cols = np.flatnonzero(csum >= frac * csum.max())
    return (rows[0] * pool, (rows[-1] + 1) * pool,
            cols[0] * pool, (cols[-1] + 1) * pool)


def bright_content_bbox(img: np.ndarray, *, lum_thresh: float = 0.15,
                        pool: int = 8, frac: float = 0.2
                        ) -> tuple[int, int, int, int]:
    """Bounding box (r0, r1, c0, c1) of the large bright region of the image.

    Downsampling by ``pool`` with a mean filter first dilutes thin UI text /
    buttons below the threshold while a lit scene region (the Cornell box)
    survives — so the same detector works on our raw renders and on the
    reference's full-app screenshots.
    """
    small = box_filter(img, pool)
    lum = small @ np.asarray([0.2126, 0.7152, 0.0722], np.float32)
    mask = lum > lum_thresh
    if not mask.any():
        raise ValueError("no bright content found")
    return _occupancy_bbox(mask, pool, frac)


def color_region_bbox(img: np.ndarray, rgb, *, tol: float = 0.25,
                      pool: int = 8, frac: float = 0.2
                      ) -> tuple[int, int, int, int]:
    """Bounding box of the region close to a known color (e.g. the Whitted
    sky (0.2, 0.7, 0.8)) — locates the viewport inside a screenshot."""
    small = box_filter(img, pool)
    dist = np.abs(small - np.asarray(rgb, np.float32)).max(-1)
    mask = dist < tol
    if not mask.any():
        raise ValueError("no region matching color found")
    return _occupancy_bbox(mask, pool, frac)


def cornell_box_crop(img: np.ndarray, *, pool: int = 8) -> np.ndarray:
    """Crop the lit Cornell box out of a render or a reference screenshot:
    locate the viewport by its night-sky border (``Renderer.cpp:145`` color
    (12, 20, 69)/255, displayed linearly), then the bright box inside it."""
    night = (12 / 255.0, 20 / 255.0, 69 / 255.0)
    vp = crop(img, color_region_bbox(img, night, tol=0.1, pool=pool))
    return crop(vp, bright_content_bbox(vp, lum_thresh=0.15, pool=pool))


def crop(img: np.ndarray, bbox) -> np.ndarray:
    r0, r1, c0, c1 = bbox
    return img[r0:r1, c0:c1]


def grid_means(img: np.ndarray, n: int = 8) -> np.ndarray:
    """Reduce an image to an (n, n, 3) grid of cell-mean colors (cells split
    as evenly as integer edges allow)."""
    h, w = img.shape[:2]
    re = np.linspace(0, h, n + 1).round().astype(int)
    ce = np.linspace(0, w, n + 1).round().astype(int)
    out = np.zeros((n, n, 3), np.float32)
    for i in range(n):
        for j in range(n):
            cell = img[re[i]:re[i + 1], ce[j]:ce[j + 1]]
            out[i, j] = cell.reshape(-1, 3).mean(0)
    return out


def grid_diff(a: np.ndarray, b: np.ndarray, n: int = 8):
    """(mean_abs, max_abs) difference between two images' n x n grids."""
    ga, gb = grid_means(a, n), grid_means(b, n)
    d = np.abs(ga - gb)
    return float(d.mean()), float(d.max())


def sky_and_object_stats(img: np.ndarray, sky_rgb, *, tol: float = 0.22):
    """(mean sky RGB, mean non-sky RGB, non-sky fraction) — the loose
    comparison for free-flown mesh screenshots."""
    dist = np.abs(img - np.asarray(sky_rgb, np.float32)).max(-1)
    sky = dist < tol
    if not sky.any() or sky.all():
        raise ValueError("sky segmentation failed")
    return (img[sky].mean(0), img[~sky].mean(0),
            float((~sky).mean()))
