"""Seeded synthetic inspection scenes, built with numpy alone.

Two deployments at the reference's own sizes (README.md of the reference,
"Test images" table): the flagship rotation case (Src7/Dst7: a 4024x3036
frame, a 762x521 template, 3 targets at 0 and +-120 degrees) and the
many-target case (Test7/Src10: a 3648x3648 frame, a 54x54 template, 100
targets at 0 degrees). The reference's own images are not redistributable
in full, so each scene is rebuilt at the same shapes from a seed; the
workload (angle count, pyramid depth, score-map sizes) is the same.

Each builder returns (scene u8 [H, W], template u8 [h, w], truth), where
truth is a list of (center_x, center_y, angle_deg) in the convention of
MatchResult (angle = the rotation the matcher reports).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

Truth = List[Tuple[float, float, float]]

# Match configurations of the two deployments.
FLAGSHIP_CONFIG = dict(max_pos=3, score=0.7, tolerance_angle=180.0,
                       max_overlap=0.1, use_subpixel=True)
MANY_TARGETS_CONFIG = dict(max_pos=100, score=0.5, tolerance_angle=0.0,
                           max_overlap=0.5, min_reduce_area=1024)
FLAGSHIP_MIN_REDUCE_AREA = 256


def _disk(h, w, cy, cx, r):
    yy, xx = np.mgrid[0:h, 0:w]
    return (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r


def _thick_line(h, w, p0, p1, width):
    """Mask of the segment p0-p1 (x, y) drawn `width` px wide."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    (x0, y0), (x1, y1) = p0, p1
    dx, dy = x1 - x0, y1 - y0
    t = np.clip(((xx - x0) * dx + (yy - y0) * dy) / (dx * dx + dy * dy),
                0.0, 1.0)
    return np.hypot(xx - (x0 + t * dx), yy - (y0 + t * dy)) <= width / 2.0


def flagship_template(rng: np.random.Generator) -> np.ndarray:
    """A 521x762 part image: frame, disk, diagonal bar, blocky glyphs."""
    th, tw = 521, 762
    t = np.full((th, tw), 50, np.uint8)
    t[30:th - 30, 30:tw - 30] = 210
    t[42:th - 42, 42:tw - 42] = 50
    t[_disk(th, tw, th // 2, tw // 3, 90)] = 160
    t[_thick_line(th, tw, (tw // 2, 40), (tw - 60, th - 60), 16)] = 250
    for k in range(4):  # four glyph-like blocks along the bottom
        x0 = 70 + 120 * k
        t[th - 170:th - 90, x0:x0 + 20] = 240
        t[th - 170:th - 150, x0:x0 + 70] = 240
        t[th - 120:th - 100, x0:x0 + 50 + 10 * k] = 240
    return t + rng.integers(0, 20, t.shape, dtype=np.uint8)


def paste_rotated(scene: np.ndarray, tpl: np.ndarray, cx: float, cy: float,
                  angle_deg: float) -> None:
    """Write `tpl`, rotated counter-clockwise by angle_deg about its center
    (cv::getRotationMatrix2D's convention), into `scene` centered at
    (cx, cy); bilinear, rounded to u8, pixels outside the template left
    untouched."""
    th, tw = tpl.shape
    a = np.deg2rad(angle_deg)
    ca, sa = np.cos(a), np.sin(a)
    r = int(np.ceil(np.hypot(th, tw) / 2)) + 2
    y0, y1 = max(int(cy) - r, 0), min(int(cy) + r + 1, scene.shape[0])
    x0, x1 = max(int(cx) - r, 0), min(int(cx) + r + 1, scene.shape[1])
    yy, xx = np.mgrid[y0:y1, x0:x1].astype(np.float64)
    dx, dy = xx - cx, yy - cy
    # (cx, cy) is the template's center in MatchResult's convention: the
    # mean of its corners, i.e. template pixel coordinate (tw/2, th/2).
    u = ca * dx - sa * dy + tw / 2.0
    v = sa * dx + ca * dy + th / 2.0
    inside = (u >= 0) & (u <= tw - 1) & (v >= 0) & (v <= th - 1)
    u, v = u[inside], v[inside]
    u0 = np.minimum(np.floor(u).astype(np.int64), tw - 2)
    v0 = np.minimum(np.floor(v).astype(np.int64), th - 2)
    fu, fv = u - u0, v - v0
    t = tpl.astype(np.float64)
    val = ((1 - fu) * (1 - fv) * t[v0, u0] + fu * (1 - fv) * t[v0, u0 + 1]
           + (1 - fu) * fv * t[v0 + 1, u0] + fu * fv * t[v0 + 1, u0 + 1])
    region = scene[y0:y1, x0:x1]
    region[inside] = np.clip(np.rint(val), 0, 255).astype(np.uint8)


def flagship_scene(seed: int = 0):
    """Src7-shaped frame (3036x4024), 521x762 template, 3 targets."""
    rng = np.random.default_rng(seed)
    tpl = flagship_template(rng)
    scene = rng.integers(0, 40, size=(3036, 4024), dtype=np.uint8)
    truth = []
    for cx, cy, ang in [(1725.9, 1045.4, 0.05), (2662.9, 1537.4, -119.98),
                        (1768.9, 2098.5, 120.15)]:
        paste_rotated(scene, tpl, cx, cy, ang)
        truth.append((cx, cy, ang))
    return scene, tpl, truth


def many_targets_template(rng: np.random.Generator) -> np.ndarray:
    """A 54x54 washer-like part: dark ring with a notch on a bright pad."""
    h = w = 54
    t = np.full((h, w), 225, np.uint8)
    ring = _disk(h, w, 26.5, 26.5, 24) & ~_disk(h, w, 26.5, 26.5, 11)
    t[ring] = 60
    t[20:34, 40:54] = 225  # notch: breaks the rotational symmetry
    t[4:12, 4:12] = 20
    return t - rng.integers(0, 12, t.shape, dtype=np.uint8)


def many_targets_scene(seed: int = 0, n_targets: int = 100):
    """Test7-shaped frame (3648x3648), 54x54 template, n_targets placed
    without overlap on a bright, noisy background."""
    rng = np.random.default_rng(seed)
    tpl = many_targets_template(rng)
    H = W = 3648
    scene = (np.full((H, W), 235, np.uint8)
             - rng.integers(0, 12, (H, W), dtype=np.uint8))
    th, tw = tpl.shape
    placed: List[Tuple[int, int]] = []
    while len(placed) < n_targets:
        y = int(rng.integers(40, H - th - 40))
        x = int(rng.integers(40, W - tw - 40))
        if any(abs(y - py) < th + 6 and abs(x - px) < tw + 6
               for py, px in placed):
            continue
        scene[y:y + th, x:x + tw] = tpl
        placed.append((y, x))
    truth = [(x + tw / 2.0, y + th / 2.0, 0.0)
             for y, x in placed]
    return scene, tpl, truth


def match_truth_errors(results, truth: Truth):
    """For each planted target, the nearest result's (center distance px,
    |angle difference| deg); inf where no result exists."""
    errs = []
    for cx, cy, ang in truth:
        best = (np.inf, np.inf)
        for r in results:
            d = float(np.hypot(r.center[0] - cx, r.center[1] - cy))
            if d < best[0]:
                da = abs((r.angle - ang + 180.0) % 360.0 - 180.0)
                best = (d, da)
        errs.append(best)
    return errs
