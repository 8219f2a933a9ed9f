"""The warp (ops/warp.py::warp_affine_batch, four per-tap gathers)
against cv2.warpAffine (INTER_LINEAR + BORDER_CONSTANT, the reference's
rotation, MatchToolDlg.cpp:856 and :1327), over the shapes the matcher
warps: top-sweep canvases, descent ROIs of every pyramid layer, canvases
larger than the source, the identity, and a batch of 7.
"""

import cv2
import numpy as np
import pytest

import jax.numpy as jnp

from fastest_image_pattern_matching_tpu.ops.warp import warp_affine_batch
from fastest_image_pattern_matching_tpu.utils import geometry


@pytest.fixture(scope="module")
def src():
    rng = np.random.default_rng(99)
    return rng.integers(0, 256, size=(200, 260), dtype=np.uint8)


def _fwd_mats(src_hw, angles, shift=(0.0, 0.0)):
    """Forward affines: rotation about the source center plus a shift —
    the construction the sweep uses."""
    h, w = src_hw
    mats = []
    for a in angles:
        m = geometry.rotation_matrix(((w - 1) / 2.0, (h - 1) / 2.0), a)
        m[0, 2] += shift[0]
        m[1, 2] += shift[1]
        mats.append(m)
    return mats


def _warp(src, mats, out_hw, border, quantize=True):
    inv = np.asarray([geometry.invert_affine(m) for m in mats], np.float32)
    return np.asarray(warp_affine_batch(
        jnp.asarray(src, jnp.float32), jnp.asarray(inv), out_hw,
        float(border), quantize=quantize))


def _cv2(src, mats, out_hw, border):
    return np.stack([cv2.warpAffine(
        src, m, (out_hw[1], out_hw[0]), flags=cv2.INTER_LINEAR,
        borderMode=cv2.BORDER_CONSTANT, borderValue=border).astype(np.float32)
        for m in mats])


def _assert_cv2_parity(got, ref):
    """OpenCV rounds its interpolation weights in fixed point: allow one
    LSB on a small fraction of pixels, nothing larger."""
    diff = np.abs(got - ref)
    assert diff.max() <= 1.0, diff.max()
    assert np.mean(diff > 0) < 0.05, np.mean(diff > 0)


@pytest.mark.parametrize("out_hw", [(48, 150), (24, 64), (96, 100)])
def test_quantized_matches_cv2(src, out_hw):
    mats = _fwd_mats(src.shape, [0.0, 13.5, -37.25, 120.0])
    got = _warp(src, mats, out_hw, 64)
    _assert_cv2_parity(got, _cv2(src, mats, out_hw, 64))


def test_unquantized_close_to_cv2(src):
    mats = _fwd_mats(src.shape, [7.0, -97.6])
    got = _warp(src, mats, (40, 130), 0, quantize=False)
    ref = _cv2(src, mats, (40, 130), 0)
    assert np.abs(got - ref).max() <= 1.0


@pytest.mark.parametrize("border", [0, 200, 255])
def test_edge_clipped_border(src, border):
    """A canvas larger than the rotated source: out-of-image taps read
    the border constant, blended at the true edge like BORDER_CONSTANT."""
    mats = _fwd_mats(src.shape, [30.0, -150.0], shift=(60.0, 40.0))
    out_hw = (264, 390)
    got = _warp(src, mats, out_hw, border)
    _assert_cv2_parity(got, _cv2(src, mats, out_hw, border))
    assert (got == float(border)).any()


def test_identity_roundtrip(src):
    got = _warp(src, _fwd_mats(src.shape, [0.0]), src.shape, 0)
    np.testing.assert_array_equal(got[0], src.astype(np.float32))


def test_batch_of_seven(src):
    mats = _fwd_mats(src.shape, [0.0, 5.0, 45.0, 90.0, -5.0, -45.0, -90.0])
    got = _warp(src, mats, (24, 140), 0)
    _assert_cv2_parity(got, _cv2(src, mats, (24, 140), 0))


@pytest.mark.parametrize("out_hw", [
    (23, 30),    # flagship L5 descent ROI
    (39, 54),    # flagship L4 descent ROI
    (16, 100),   # wide, flat ROI
    (30, 28),    # near-square ROI
    (68, 70),    # flagship top-sweep canvas
])
def test_roi_shapes_match_cv2(src, out_hw):
    mats = _fwd_mats(src.shape, [0.0, 13.5, -37.25, 120.0, 89.5],
                     shift=(-31.25, 12.75))
    got = _warp(src, mats, out_hw, 64)
    _assert_cv2_parity(got, _cv2(src, mats, out_hw, 64))


def test_small_roi_near_border(src):
    mats = _fwd_mats(src.shape, [4.0, -170.0],
                     shift=(src.shape[1] / 2 - 4, src.shape[0] / 2 - 6))
    got = _warp(src, mats, (24, 32), 200)
    _assert_cv2_parity(got, _cv2(src, mats, (24, 32), 200))
