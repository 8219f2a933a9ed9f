"""warpAffine / rotation geometry parity (reference: MatchToolDlg.cpp:845-856
top-layer canvas, :1312-1328 rotated ROI, :1469-1480 ptRotatePt2f)."""

import cv2
import numpy as np
import pytest

from fastest_image_pattern_matching_tpu.ops.warp import (
    make_rotation_invmaps, rotate_pt_jnp, warp_affine_batch)
from fastest_image_pattern_matching_tpu.utils import geometry

import jax.numpy as jnp


@pytest.mark.parametrize("angle", [0.0, 13.7, 90.0, -47.3, 180.0, 245.0])
def test_rotate_pt_matches_getRotationMatrix2D(angle):
    center = (31.5, 17.0)
    m = cv2.getRotationMatrix2D(center, angle, 1.0)
    pts = np.array([[3.0, 4.0], [60.2, 30.9], [0.0, 0.0]])
    want = (m[:, :2] @ pts.T + m[:, 2:]).T
    got = geometry.rotate_pt(pts, center, angle * np.pi / 180)
    np.testing.assert_allclose(got, want, atol=1e-9)
    got_j = np.asarray(rotate_pt_jnp(jnp.asarray(pts, jnp.float32),
                                     jnp.asarray(center, jnp.float32),
                                     jnp.float32(angle * np.pi / 180)))
    np.testing.assert_allclose(got_j, want, atol=1e-3)


def test_rotation_matrix_matches_opencv():
    m = geometry.rotation_matrix((10.0, 20.0), 33.0)
    ref = cv2.getRotationMatrix2D((10.0, 20.0), 33.0, 1.0)
    np.testing.assert_allclose(m, ref, atol=1e-12)


def test_invert_affine():
    m = geometry.rotation_matrix((5.0, 7.0), 28.0)
    m[0, 2] += 3.5
    m[1, 2] -= 1.25
    inv = geometry.invert_affine(m)
    p = np.array([11.0, 13.0, 1.0])
    fwd = m @ p
    back = inv @ np.array([fwd[0], fwd[1], 1.0])
    np.testing.assert_allclose(back, p[:2], atol=1e-10)


@pytest.mark.parametrize("angle", [0.0, 25.0, -66.6, 145.0])
def test_warp_affine_batch_matches_opencv(rng, angle):
    src = rng.integers(0, 256, size=(83, 97), dtype=np.uint8)
    center = ((src.shape[1] - 1) / 2.0, (src.shape[0] - 1) / 2.0)
    out_wh = (120, 110)
    m = geometry.rotation_matrix(center, angle)
    m[0, 2] += 5.0
    m[1, 2] += 2.0
    ref = cv2.warpAffine(src, m, out_wh, flags=cv2.INTER_LINEAR,
                         borderMode=cv2.BORDER_CONSTANT, borderValue=77)
    inv = geometry.invert_affine(m)[None]
    got = np.asarray(warp_affine_batch(
        jnp.asarray(src, jnp.float32), jnp.asarray(inv, jnp.float32),
        (out_wh[1], out_wh[0]), 77.0, quantize=True))
    diff = np.abs(got - ref.astype(np.float32))
    # OpenCV's fixed-point tables round slightly differently; allow 1 LSB
    # on a small fraction of pixels.
    assert np.mean(diff > 1.0) < 0.01, f"mean={diff.mean()} max={diff.max()}"
    assert diff.mean() < 0.2


def test_make_rotation_invmaps_matches_host():
    center = (41.0, 23.5)
    angles = np.array([12.0, -30.0], np.float32)
    shifts = np.array([[3.0, -2.0], [0.5, 7.0]], np.float32)
    got = np.asarray(make_rotation_invmaps(
        (jnp.float32(center[0]), jnp.float32(center[1])),
        jnp.asarray(angles), jnp.asarray(shifts)))
    for i, (a, s) in enumerate(zip(angles, shifts)):
        m = geometry.rotation_matrix(center, float(a))
        m[0, 2] += s[0]
        m[1, 2] += s[1]
        want = geometry.invert_affine(m)
        np.testing.assert_allclose(got[i], want, atol=1e-4)
