"""ORB feature matching — the reference's secondary path
(ORBMatch/ORBFeatureMatcher.{h,cpp}), redesigned for an accelerator.

Reference pipeline (ORBFeatureMatcher.cpp:21-201): ORB detect+describe on
both images (500 features, 1.2 scale, 8 levels, Harris score, :14) ->
BFMatcher Hamming (:58-60) -> top-150 by distance (:76-82) -> RANSAC
homography (thresh 2.0, 2000 iters, conf 0.99, :104-109) -> inlier
extraction + average pixel shift (:141-185) -> corners via
perspectiveTransform(H^-1) (:329-371).

Accelerator formulation — every data-dependent loop becomes a fixed-size
batch:
  * FAST-9 corners: 16 static shifted views + circular-run reduction.
  * Harris response ranking: Sobel + box sums + det-k*tr^2, top-K per level.
  * Orientation: intensity-centroid moments as masked patch sums.
  * rBRIEF: 256 deterministic pairs, steered by orientation, gathered in
    one batched lookup.
  * Hamming matching: descriptors as ±1 bf16 vectors; distance
    D = (256 - B_s @ B_t^T)/2 — one bf16 matmul instead of O(Ns*Nt*256)
    scalar popcounts.
  * RANSAC: 2000 pre-sampled 4-point hypotheses solved and scored in one
    batch (vmapped 8x8 solve + one matmul-like reprojection pass), then a
    DLT refit on the winner's inliers. No data-dependent iteration.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class ORBConfig:
    max_features: int = 500        # cv::ORB::create nfeatures (:14)
    scale_factor: float = 1.2
    n_levels: int = 8
    fast_threshold: int = 20
    max_good_matches: int = 150    # top-N matches kept (:80)
    ransac_threshold: float = 2.0  # (:105)
    ransac_iters: int = 2000       # (:106)
    harris_k: float = 0.04
    patch_size: int = 31


@dataclasses.dataclass
class ORBResult:
    is_matched: bool
    homography: Optional[np.ndarray]      # maps source pts -> template pts
    num_inliers: int
    num_good_matches: int
    avg_pixel_shift: float
    corners: Optional[np.ndarray]         # template corners in source frame
    src_pts: Optional[np.ndarray] = None  # matched source points [M, 2]
    dst_pts: Optional[np.ndarray] = None  # matched template points [M, 2]
    inlier_mask: Optional[np.ndarray] = None
    # physics-pixel calibration (ORBFeatureMatcher.cpp:179-180)
    scale_mm_per_pix: float = 0.0
    # rotation angle (deg) extracted from the homography's affine part —
    # an extension; the reference leaves rotationAngle unset (:188)
    rotation_angle: float = 0.0


# Every f32 product here (Harris sums, the rounded descriptor blur,
# homography algebra) must be exact f32, not TF32: GPU matmuls and
# convolutions default to TF32, which would change rankings and bits.
_HIGHEST = jax.lax.Precision.HIGHEST

# FAST-9/16 Bresenham circle offsets (x, y), standard ordering.
_FAST_OFFSETS = np.array([
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
], dtype=np.int32)


def _fast_corners(img: jnp.ndarray, threshold: float) -> jnp.ndarray:
    """FAST-9 corner mask [H, W] (True where >=9 contiguous circle pixels
    are all brighter than p+t or all darker than p-t)."""
    H, W = img.shape
    pad = jnp.pad(img, 3, mode="edge")
    views = jnp.stack([pad[3 + dy:3 + dy + H, 3 + dx:3 + dx + W]
                       for (dx, dy) in _FAST_OFFSETS])  # [16, H, W]
    bright = views > img[None] + threshold
    dark = views < img[None] - threshold

    def runs(mask):
        m2 = jnp.concatenate([mask, mask[:8]], axis=0)  # wraparound
        acc = jnp.ones_like(img, dtype=bool)
        hit = jnp.zeros_like(img, dtype=bool)
        for k in range(16):
            window = m2[k:k + 9]
            hit = hit | jnp.all(window, axis=0)
        return hit

    out = runs(bright) | runs(dark)
    # Exclude the border band where the circle leaves the image.
    out = out.at[:3].set(False).at[-3:].set(False)
    out = out.at[:, :3].set(False).at[:, -3:].set(False)
    return out


def _harris_response(img: jnp.ndarray, k: float) -> jnp.ndarray:
    """Harris corner response via Sobel gradients + 7x7 box window."""
    sob_x = jnp.asarray([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], jnp.float32)
    sob_y = sob_x.T

    def conv2(x, kern):
        return jax.lax.conv_general_dilated(
            x[None, None], kern[None, None], (1, 1), "SAME",
            dimension_numbers=("NCHW", "OIHW", "NCHW"),
            precision=_HIGHEST)[0, 0]

    ix = conv2(img, sob_x)
    iy = conv2(img, sob_y)
    box = jnp.ones((7, 7), jnp.float32)
    sxx = conv2(ix * ix, box)
    syy = conv2(iy * iy, box)
    sxy = conv2(ix * iy, box)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return det - k * tr * tr


def _local_max_3x3(r: jnp.ndarray) -> jnp.ndarray:
    mx = jax.lax.reduce_window(r, -jnp.inf, jax.lax.max, (3, 3), (1, 1),
                               "SAME")
    return r >= mx


def _orientation(img: jnp.ndarray, pts: jnp.ndarray, radius: int = 15
                 ) -> jnp.ndarray:
    """Intensity-centroid orientation (rad) for keypoints [N, 2] (x, y)."""
    d = 2 * radius + 1
    oy, ox = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    circ = (ox * ox + oy * oy) <= radius * radius
    ox_j = jnp.asarray(ox * circ, jnp.float32)
    oy_j = jnp.asarray(oy * circ, jnp.float32)
    circ_j = jnp.asarray(circ, jnp.float32)
    padded = jnp.pad(img, radius, mode="edge")

    def one(pt):
        x0 = pt[0].astype(jnp.int32)
        y0 = pt[1].astype(jnp.int32)
        patch = jax.lax.dynamic_slice(padded, (y0, x0), (d, d)) * circ_j
        m10 = jnp.sum(patch * ox_j)
        m01 = jnp.sum(patch * oy_j)
        return jnp.arctan2(m01, m10)

    return jax.vmap(one)(pts)


@functools.lru_cache(maxsize=1)
def _brief_pattern() -> np.ndarray:
    """The 256-pair rBRIEF sampling pattern [256, 4] as (x1, y1, x2, y2).

    Default: cv::ORB's learned pattern (models/orb_bit_pattern.npy),
    recovered from the installed OpenCV runtime by black-box probing
    (tools/recover_brief_pattern.py) — with it, descriptors are
    bit-compatible with cv::ORB's on shared keypoints (up to blur
    rounding ties; tests/test_orb_descriptor_parity.py). Falls back to a
    seeded Gaussian pattern (BRIEF-style, sigma = patch/5) if the table
    file is absent."""
    import os
    path = os.path.join(os.path.dirname(__file__), "orb_bit_pattern.npy")
    if os.path.exists(path):
        return np.load(path).astype(np.int32)
    rng = np.random.default_rng(0x5EED)
    sigma = 31 / 5.0
    pts = np.clip(np.round(rng.normal(0, sigma, size=(256, 4))), -13, 13)
    return pts.astype(np.int32)


@functools.lru_cache(maxsize=1)
def _gauss7_kernel() -> np.ndarray:
    """cv::ORB's descriptor pre-blur: 7x7 Gaussian, sigma 2 (the kernel
    cv::getGaussianKernel(7, 2) produces, established empirically by the
    delta-scan in tools/recover_brief_pattern.py)."""
    d = np.arange(-3, 4, dtype=np.float64)
    g = np.exp(-(d * d) / 8.0)
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def _descriptors(img: jnp.ndarray, pts: jnp.ndarray, angles: jnp.ndarray
                 ) -> jnp.ndarray:
    """Steered-BRIEF descriptors as ±1 float [N, 256]. Pixels are compared
    on the 7x7/sigma-2 Gaussian-blurred image rounded to integers —
    cv::ORB's model, so bits match cv2 descriptors on shared keypoints
    (up to fixed-point blur ties)."""
    kern = jnp.asarray(_gauss7_kernel())
    sm = jax.lax.conv_general_dilated(
        img[None, None], kern[None, None], (1, 1), "SAME",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=_HIGHEST)[0, 0]
    sm = jnp.round(sm)
    H, W = img.shape
    pat = jnp.asarray(_brief_pattern(), jnp.float32)  # [256, 4]

    ca = jnp.cos(angles)[:, None]
    sa = jnp.sin(angles)[:, None]

    def rot(xs, ys):
        # Rotate pattern offsets by keypoint orientation (steered BRIEF).
        rx = ca * xs[None] - sa * ys[None]
        ry = sa * xs[None] + ca * ys[None]
        return rx, ry

    x1, y1 = rot(pat[:, 0], pat[:, 1])
    x2, y2 = rot(pat[:, 2], pat[:, 3])

    def sample(xo, yo):
        xi = jnp.clip(jnp.round(pts[:, 0:1] + xo), 0, W - 1).astype(jnp.int32)
        yi = jnp.clip(jnp.round(pts[:, 1:2] + yo), 0, H - 1).astype(jnp.int32)
        return sm[yi, xi]

    bits = sample(x1, y1) < sample(x2, y2)
    return jnp.where(bits, 1.0, -1.0).astype(jnp.float32)


def _detect_level(img: jnp.ndarray, cfg: ORBConfig, k_feat: int):
    """Top-k_feat keypoints on one pyramid level.
    Returns (pts [k, 2] f32, resp [k], valid [k])."""
    fast = _fast_corners(img, float(cfg.fast_threshold))
    harris = _harris_response(img, cfg.harris_k)
    # Rank FAST pixels by Harris (like ORB's HARRIS_SCORE) and 3x3-NMS the
    # *masked* response — the raw Harris peak usually sits a pixel inside
    # the shape, off the FAST ring.
    masked = jnp.where(fast, harris, -jnp.inf)
    cand = fast & _local_max_3x3(masked)
    score = jnp.where(cand, harris, -jnp.inf)
    H, W = img.shape
    flat = score.reshape(-1)
    vals, idx = jax.lax.top_k(flat, min(k_feat, flat.shape[0]))
    ys = (idx // W).astype(jnp.float32)
    xs = (idx % W).astype(jnp.float32)
    valid = jnp.isfinite(vals)
    return jnp.stack([xs, ys], -1), vals, valid


def detect_and_describe(img: np.ndarray, cfg: ORBConfig):
    """Multi-scale ORB features.

    Returns (pts [N,2] in level-0 coords, desc ±1 [N,256], valid [N]).
    Fixed N = cfg.max_features; invalid slots are masked.
    Trace-compatible: may be called on a traced image inside jit (the ORB
    bench jits whole pipeline prefixes, tools/orb_bench.py).
    """
    img_j = jnp.asarray(img, jnp.float32)
    n = cfg.n_levels
    # Geometric per-level feature budget like OpenCV ORB.
    factor = 1.0 / cfg.scale_factor
    ndesired = cfg.max_features * (1 - factor) / (1 - factor ** n)
    budgets = []
    remaining = cfg.max_features
    for i in range(n):
        b = min(int(round(ndesired * factor ** i)), remaining)
        if i == n - 1:
            b = remaining
        budgets.append(max(b, 0))
        remaining -= b

    all_pts, all_desc, all_valid = [], [], []
    cur = img_j
    for lvl in range(n):
        scale = cfg.scale_factor ** lvl
        if lvl > 0:
            h = max(8, int(round(img_j.shape[0] / scale)))
            w = max(8, int(round(img_j.shape[1] / scale)))
            cur = jax.image.resize(img_j, (h, w), "linear")
        if budgets[lvl] == 0:
            continue
        pts, resp, valid = _detect_level(cur, cfg, budgets[lvl])
        ang = _orientation(cur, pts)
        desc = _descriptors(cur, pts, ang)
        all_pts.append(pts * scale)
        all_desc.append(desc)
        all_valid.append(valid)

    pts = jnp.concatenate(all_pts)[: cfg.max_features]
    desc = jnp.concatenate(all_desc)[: cfg.max_features]
    valid = jnp.concatenate(all_valid)[: cfg.max_features]
    return pts, desc, valid


def hamming_match(desc_s: jnp.ndarray, valid_s, desc_t: jnp.ndarray, valid_t):
    """Brute-force Hamming via one matmul on ±1 bf16 descriptors:
    dist = (256 - <s, t>) / 2  (exact: entries are small integers).
    Returns (train_idx [Ns], dist [Ns]) — best template match per source
    feature, like BFMatcher::match (ORBFeatureMatcher.cpp:58-60)."""
    dot = jnp.dot(desc_s.astype(jnp.bfloat16), desc_t.astype(jnp.bfloat16).T,
                  preferred_element_type=jnp.float32)
    dist = (256.0 - dot) / 2.0
    dist = jnp.where(valid_t[None, :], dist, jnp.inf)
    dist = jnp.where(valid_s[:, None], dist, jnp.inf)
    ti = jnp.argmin(dist, axis=1)
    return ti, dist[jnp.arange(dist.shape[0]), ti]


def _solve_h_4pt(src4: jnp.ndarray, dst4: jnp.ndarray) -> jnp.ndarray:
    """Exact homography from 4 correspondences: 8x8 linear solve with
    h33 = 1. Returns [3, 3] (may be garbage for degenerate quads — those
    hypotheses simply score few inliers)."""
    x, y = src4[:, 0], src4[:, 1]
    u, v = dst4[:, 0], dst4[:, 1]
    z = jnp.zeros_like(x)
    o = jnp.ones_like(x)
    rows_u = jnp.stack([x, y, o, z, z, z, -u * x, -u * y], axis=1)
    rows_v = jnp.stack([z, z, z, x, y, o, -v * x, -v * y], axis=1)
    A = jnp.concatenate([rows_u, rows_v], axis=0)          # [8, 8]
    b = jnp.concatenate([u, v], axis=0)                    # [8]
    h = jnp.linalg.solve(A + 1e-8 * jnp.eye(8), b)
    return jnp.concatenate([h, jnp.ones(1)]).reshape(3, 3)


def _project(H: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    ph = jnp.matmul(pts, H[:, :2].T, precision=_HIGHEST) + H[:, 2][None]
    w = jnp.where(jnp.abs(ph[:, 2]) > 1e-12, ph[:, 2], 1e-12)
    return ph[:, :2] / w[:, None]


def ransac_homography(src: jnp.ndarray, dst: jnp.ndarray, valid: jnp.ndarray,
                      thresh: float, iters: int, seed: int = 0):
    """Batched-hypothesis RANSAC: sample all 4-point subsets up front,
    solve all homographies with one vmap, score all with one pass, argmax
    inliers, then DLT-refit on the winner's inliers (normalized, via eigh).
    Returns (H [3,3], inlier_mask [M])."""
    M = src.shape[0]
    key = jax.random.PRNGKey(seed)
    # Sample only among valid correspondences: bias sampling by masking —
    # draw from the valid prefix using random uniforms scaled by count.
    nvalid = jnp.maximum(jnp.sum(valid), 4)
    ranks = jnp.cumsum(valid) - 1                     # index among valid
    # Map "valid rank r" -> original index via scatter.
    pos = jnp.nonzero(valid, size=M, fill_value=0)[0]  # [M]
    r = jax.random.randint(key, (iters, 4), 0, 2**30) % nvalid
    samples = pos[r]                                   # [iters, 4]

    Hs = jax.vmap(lambda i: _solve_h_4pt(src[i], dst[i]))(samples)

    def score(Hm):
        proj = _project(Hm, src)
        err = jnp.sum((proj - dst) ** 2, axis=1)
        inl = (err < thresh * thresh) & valid
        return jnp.sum(inl), inl

    counts, inls = jax.vmap(score)(Hs)
    best = jnp.argmax(counts)
    mask = inls[best]

    def refit(mask_in):
        """Normalized DLT on the masked inliers (all M rows,
        zero-weighted outliers)."""
        w = mask_in.astype(jnp.float32)
        wsum = jnp.maximum(jnp.sum(w), 1.0)

        def norm_pts(p):
            c = jnp.sum(p * w[:, None], axis=0) / wsum
            d = jnp.sqrt(jnp.sum((p - c) ** 2, axis=1)) * w
            s = jnp.sqrt(2.0) / jnp.maximum(jnp.sum(d) / wsum, 1e-9)
            T = jnp.array([[s, 0, -s * c[0]], [0, s, -s * c[1]],
                           [0, 0, 1.0]])
            return (p - c) * s, T

        sn, Ts = norm_pts(src)
        dn, Td = norm_pts(dst)
        x, y = sn[:, 0], sn[:, 1]
        u, v = dn[:, 0], dn[:, 1]
        z = jnp.zeros_like(x)
        o = jnp.ones_like(x)
        r1 = jnp.stack([x, y, o, z, z, z, -u * x, -u * y, -u], 1) * w[:, None]
        r2 = jnp.stack([z, z, z, x, y, o, -v * x, -v * y, -v], 1) * w[:, None]
        A = jnp.concatenate([r1, r2], axis=0)
        _, vecs = jnp.linalg.eigh(jnp.matmul(A.T, A, precision=_HIGHEST))
        Hn = vecs[:, 0].reshape(3, 3)
        Hf = jnp.linalg.solve(Td, jnp.matmul(Hn, Ts, precision=_HIGHEST))
        return Hf / jnp.where(jnp.abs(Hf[2, 2]) > 1e-12, Hf[2, 2], 1e-12)

    # Iterated local optimization (LO-RANSAC style) from the top-8
    # hypotheses (not just the argmax — a skewed max-count hypothesis can
    # trap the refit in its basin): refit on inliers, recompute inliers,
    # 3 static rounds each, then pick the best final (count, -error).
    # Refit sets use a wide-then-narrow threshold schedule (2t -> 1.5t ->
    # t, the LO-RANSAC inner trick): the widened set stabilizes the LS
    # solve against near-threshold jitter while acceptance is always
    # judged at the narrow threshold. Measured on the Src9 e-clip crop:
    # max corner error 13.2/12.7/10.6 px across seeds without the
    # schedule -> consistently tighter with it (see
    # tests/test_orb_cv2_parity.py bounds).
    def sq_err(Hm):
        proj = _project(Hm, src)
        return jnp.sum((proj - dst) ** 2, axis=1)

    def score_at(Hm, t):
        inl = (sq_err(Hm) < t * t) & valid
        return jnp.sum(inl), inl

    def lo(h0, mask0):
        Hb, mb = h0, mask0
        cur = mask0
        for mult in (2.0, 1.5, 1.0):
            Hf = refit(cur)
            _, mf = score(Hf)                 # narrow: acceptance metric
            better = jnp.sum(mf) >= jnp.sum(mb)
            Hb = jnp.where(better, Hf, Hb)
            mb = jnp.where(better, mf, mb)
            _, cur = score_at(Hf, thresh * mult)  # wide: next refit set
        e = sq_err(Hb)
        err = jnp.sum(jnp.where(mb, e, 0.0))
        return Hb, mb, jnp.sum(mb), err

    n_lo = min(8, iters)
    _, top_idx = jax.lax.top_k(counts, n_lo)
    H_lo, m_lo, c_lo, e_lo = jax.vmap(lo)(Hs[top_idx], inls[top_idx])
    # Rank: most inliers, then least inlier reprojection error.
    pick = jnp.argmax(c_lo.astype(jnp.float32) * 1e6 - e_lo)
    return H_lo[pick], m_lo[pick]


def _orb_pipeline(cfg: ORBConfig, seed: int, source, template):
    """Traced single-pair pipeline body shared by _orb_core (one pair),
    _orb_core_many (one template vs a source batch) and the AOT export.
    Returns the packed f32 result vector (see _orb_core docstring)."""
    pt, dt, vt = detect_and_describe(template, cfg)
    return _match_against(cfg, seed, source, (pt, dt, vt))


def _match_against(cfg: ORBConfig, seed: int, source, templ_feats):
    pt, dt, vt = templ_feats
    ps, ds, vs = detect_and_describe(source, cfg)
    ti, dist = hamming_match(ds, vs, dt, vt)
    n_finite = jnp.sum(jnp.isfinite(dist).astype(jnp.int32))
    N = min(cfg.max_good_matches, dist.shape[0])
    neg = jnp.where(jnp.isfinite(dist), -dist, -jnp.inf)
    _, order = jax.lax.top_k(neg, N)
    s_pts = ps[order]
    t_pts = pt[ti[order]]
    good_valid = jnp.isfinite(dist[order])
    H, mask = ransac_homography(s_pts, t_pts, good_valid,
                                cfg.ransac_threshold, cfg.ransac_iters,
                                seed)
    # ONE packed f32 output: each separately-fetched leaf costs its own
    # device-to-host transfer.
    return jnp.concatenate([
        H.reshape(9).astype(jnp.float32),
        jnp.float32(n_finite)[None],
        mask.astype(jnp.float32),
        good_valid.astype(jnp.float32),
        s_pts.reshape(2 * N).astype(jnp.float32),
        t_pts.reshape(2 * N).astype(jnp.float32),
    ])


@functools.lru_cache(maxsize=16)
def _orb_core(cfg: ORBConfig, seed: int):
    """The whole device pipeline — detect both images, Hamming match,
    top-N, batched RANSAC + LO refit — as ONE jitted program per
    (config, image shapes): a single dispatch per call instead of
    hundreds of eager op dispatches."""
    def fn(source, template):
        return _orb_pipeline(cfg, seed, source, template)

    return jax.jit(fn)


@functools.lru_cache(maxsize=16)
def _orb_core_many(cfg: ORBConfig, seed: int):
    """Batched serving variant: the template is detected+described ONCE,
    then every source in the batch is matched against it under lax.map —
    one dispatch for B pairs (the reference reruns the whole interactive
    pipeline per pair, ORBFeatureMatcher.cpp:21)."""
    def fn(sources, template):
        templ_feats = detect_and_describe(template, cfg)
        return jax.lax.map(
            lambda s: _match_against(cfg, seed, s, templ_feats), sources)

    return jax.jit(fn)


def orb_match(source: np.ndarray, template: np.ndarray,
              cfg: Optional[ORBConfig] = None, seed: int = 0,
              physics_shift_mm: float = 8.0) -> ORBResult:
    """Full ORB matching pipeline (performORBMatching parity,
    ORBFeatureMatcher.cpp:21-201) — one compiled dispatch + host-side
    result assembly."""
    cfg = cfg or ORBConfig()
    source = np.asarray(source)
    template = np.asarray(template)
    if source.ndim == 3:
        from ..utils.imageio import ensure_gray
        source = ensure_gray(source)
    if template.ndim == 3:
        from ..utils.imageio import ensure_gray
        template = ensure_gray(template)

    packed = np.asarray(_orb_core(cfg, seed)(
        jnp.asarray(source, jnp.float32),
        jnp.asarray(template, jnp.float32)))  # single host transfer
    return _result_from_packed(packed, template.shape, physics_shift_mm)


def _result_from_packed(packed: np.ndarray, templ_hw,
                        physics_shift_mm: float) -> ORBResult:
    """Host-side result assembly from the packed device vector
    (ORBFeatureMatcher.cpp:141-185 inlier stats + :329-371 corners)."""
    N = (packed.shape[0] - 10) // 6
    Hnp = packed[:9].astype(np.float64).reshape(3, 3)
    n_finite = int(packed[9])
    mask_np = packed[10:10 + N] > 0.5
    good_valid = packed[10 + N:10 + 2 * N] > 0.5
    s_np = packed[10 + 2 * N:10 + 4 * N].reshape(N, 2)
    t_np = packed[10 + 4 * N:10 + 6 * N].reshape(N, 2)
    if n_finite < 10:  # :66
        return ORBResult(False, None, 0, 0, 0.0, None)
    n_inl = int(mask_np.sum())
    if n_inl < 2:  # :156
        return ORBResult(False, None, n_inl, N, 0.0, None)

    shifts = np.linalg.norm(t_np[mask_np] - s_np[mask_np], axis=1)
    avg_shift = float(shifts.mean())
    scale_mm = (physics_shift_mm / avg_shift) if avg_shift > 1e-6 else 0.0
    rot_deg = float(np.degrees(np.arctan2(Hnp[1, 0], Hnp[0, 0])))

    # Template corners in the source frame: perspectiveTransform with
    # H^-1 (:340-353).
    h, w = templ_hw
    tc = np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float64)
    Hinv = np.linalg.inv(Hnp)
    ph = np.concatenate([tc, np.ones((4, 1))], axis=1) @ Hinv.T
    corners = ph[:, :2] / ph[:, 2:3]

    return ORBResult(
        is_matched=True, homography=Hnp,
        num_inliers=n_inl, num_good_matches=int(np.asarray(good_valid).sum()),
        avg_pixel_shift=avg_shift, corners=corners,
        src_pts=s_np, dst_pts=t_np, inlier_mask=mask_np,
        scale_mm_per_pix=scale_mm, rotation_angle=rot_deg)


def orb_match_many(sources, template: np.ndarray,
                   cfg: Optional[ORBConfig] = None, seed: int = 0,
                   physics_shift_mm: float = 8.0):
    """Match one template against a batch of same-shape sources in ONE
    compiled dispatch (template features computed once) — the serving
    analogue of repeated interactive ORB runs
    (ORBFeatureMatcher.cpp:21). Returns a list of ORBResult."""
    cfg = cfg or ORBConfig()
    sources = np.asarray(sources)
    if sources.ndim == 4:
        from ..utils.imageio import ensure_gray
        sources = ensure_gray(sources)
    template = np.asarray(template)
    if template.ndim == 3:
        from ..utils.imageio import ensure_gray
        template = ensure_gray(template)
    if sources.ndim != 3:
        raise ValueError(f"sources must be [B, H, W], got {sources.shape}")
    packed = np.asarray(_orb_core_many(cfg, seed)(
        jnp.asarray(sources, jnp.float32),
        jnp.asarray(template, jnp.float32)))  # [B, L], single transfer
    return [_result_from_packed(packed[b], template.shape, physics_shift_mm)
            for b in range(packed.shape[0])]
