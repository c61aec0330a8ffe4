"""Per-frame feature-overlay rendering — the file-sink replacement for the
reference viewer's live current-frame image panel.

The reference draws the current frame with one circle per feature as a GL
texture every frame (core/viewer/viewer.cpp:106-141: green circles,
radius 3, on the grayscale image) next to the 3D view. SURVEY.md L8
replaces the GL window with host-side artifacts; this module renders the
same overlay to PNG so a tracking failure at frame k can be debugged from
a run's output directory (``--dump_overlays N`` on the CLI dumps every
Nth frame).

Drawing is pure numpy (disk stamping) and the PNG goes through the port's
own codec (``data/png.py``), so the renderer needs neither OpenCV, PIL nor
GL. A copy of ``visionx_slam_tpu/eval/overlay.py``.
"""

from __future__ import annotations

import os

import numpy as np

from ..data import png, tum

# BGR colors matching the reference's viewer palette (viewer.cpp:123-127:
# cv::Scalar(0, 255, 0) circles on the gray image)
FEATURE_COLOR = (0, 255, 0)
LANDMARK_COLOR = (0, 165, 255)  # features with a map landmark (extension)


def draw_feature_overlay(
    gray: np.ndarray,
    px: np.ndarray,
    valid: np.ndarray,
    has_landmark: np.ndarray | None = None,
    radius: int = 3,
) -> np.ndarray:
    """Render the viewer's feature overlay (viewer.cpp:106-141): the gray
    frame as BGR with a circle per valid feature. Features with a landmark
    (when ``has_landmark`` is given) draw in a distinct color. Returns
    [H,W,3] uint8 in BGR order (as the JAX package's; ``write_png`` takes
    that)."""
    H, W = gray.shape
    img = np.repeat(gray[..., None], 3, axis=-1).astype(np.uint8)

    yy, xx = np.mgrid[-radius : radius + 1, -radius : radius + 1]
    ring = (xx * xx + yy * yy <= radius * radius) & (
        xx * xx + yy * yy >= (radius - 1) * (radius - 1)
    )
    dy, dx = np.nonzero(ring)
    dy, dx = dy - radius, dx - radius

    def stamp(points: np.ndarray, color: tuple[int, int, int]):
        if len(points) == 0:
            return
        u = np.round(points[:, 0]).astype(np.int64)
        v = np.round(points[:, 1]).astype(np.int64)
        vs = (v[:, None] + dy[None, :]).reshape(-1)
        us = (u[:, None] + dx[None, :]).reshape(-1)
        ok = (us >= 0) & (us < W) & (vs >= 0) & (vs < H)
        img[vs[ok], us[ok]] = color

    valid = np.asarray(valid, bool)
    px = np.asarray(px)
    if has_landmark is None:
        stamp(px[valid], FEATURE_COLOR)
    else:
        has_landmark = np.asarray(has_landmark, bool)
        stamp(px[valid & ~has_landmark], FEATURE_COLOR)
        stamp(px[valid & has_landmark], LANDMARK_COLOR)
    return img


def write_png(path: str, img_bgr: np.ndarray) -> None:
    """Encode a BGR uint8 image to PNG."""
    png.write_png(path, np.ascontiguousarray(img_bgr[..., ::-1]))


def dump_run_overlays(
    system,
    entries,
    every_n: int,
    out_dir: str,
) -> list[str]:
    """Dump the feature overlay of every Nth frame of a finished System
    run (the run-level analog of the reference's live panel). Features are
    re-extracted on host for the sampled frames only — extraction depends
    only on the image, so the overlay is identical to what the in-run
    extractor saw. The filename carries the tracking state so a failure
    frame is findable at a glance."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i in range(0, len(entries), max(1, every_n)):
        gray = tum.load_rgb_gray(entries[i].rgb_path)
        px, resp, desc, valid = system.extractor.extract(gray)
        img = draw_feature_overlay(gray, np.asarray(px), np.asarray(valid))
        res = system.results[i] if i < len(system.results) else None
        state = res.state if res is not None else "UNKNOWN"
        fid = res.frame_id if res is not None else i
        path = os.path.join(out_dir, f"frame_{fid:06d}_{state}.png")
        write_png(path, img)
        paths.append(path)
    return paths
