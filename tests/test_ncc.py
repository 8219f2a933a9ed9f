"""Fused NCC kernel parity vs cv::matchTemplate(TM_CCOEFF_NORMED)
(the reference computes the same quantity as TM_CCORR + CCOEFF_Denominator,
MatchToolDlg.cpp:1275-1400)."""

import cv2
import numpy as np
import pytest

import jax.numpy as jnp

from fastest_image_pattern_matching_tpu.ops.ncc import ncc_score_map, window_sums


def _stats(templ):
    area = templ.size
    mean = float(np.mean(templ, dtype=np.float64))
    var = float(np.mean((templ.astype(np.float64) - mean) ** 2))
    return mean, float(np.sqrt(var) * np.sqrt(area)), 1.0 / area


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [((64, 80), (16, 24)), ((120, 90), (33, 17)),
                                   ((50, 50), (50, 50))])
def test_ncc_matches_opencv(rng, dtype, shape):
    (H, W), (h, w) = shape
    src = rng.integers(0, 256, size=(H, W), dtype=np.uint8)
    templ = rng.integers(0, 256, size=(h, w), dtype=np.uint8)
    ref = cv2.matchTemplate(src, templ, cv2.TM_CCOEFF_NORMED)
    mean, norm, inv_area = _stats(templ)
    got = np.asarray(ncc_score_map(
        jnp.asarray(src, jnp.float32)[None], jnp.asarray(templ, jnp.float32),
        mean, norm, inv_area, False, dtype))[0]
    assert got.shape == ref.shape
    atol = 2e-4 if dtype == "f32" else 2e-3
    np.testing.assert_allclose(got, ref, atol=atol)


def test_ncc_large_template_precision(rng):
    """Layer-0-sized template: accumulation over ~400k pixels."""
    H, W, h, w = 530, 770, 521, 762
    src = rng.integers(0, 256, size=(H, W), dtype=np.uint8)
    templ = src[4:4 + h, 3:3 + w].copy()
    ref = cv2.matchTemplate(src, templ, cv2.TM_CCOEFF_NORMED)
    mean, norm, inv_area = _stats(templ)
    got = np.asarray(ncc_score_map(
        jnp.asarray(src, jnp.float32)[None], jnp.asarray(templ, jnp.float32),
        mean, norm, inv_area, False, "bf16"))[0]
    # Peak must be exactly at the crop location with score ~1.
    assert np.unravel_index(np.argmax(got), got.shape) == (4, 3)
    assert got[4, 3] > 0.999
    np.testing.assert_allclose(got, ref, atol=5e-3)


def test_flat_template_all_ones(rng):
    src = rng.integers(0, 256, size=(40, 40), dtype=np.uint8)
    templ = np.full((8, 8), 77, np.uint8)
    got = np.asarray(ncc_score_map(
        jnp.asarray(src, jnp.float32)[None], jnp.asarray(templ, jnp.float32),
        77.0, 0.0, 1 / 64.0, True, "f32"))[0]
    np.testing.assert_array_equal(got, np.ones_like(got))


def test_flat_window_guard(rng):
    """Flat source windows must score 0 (the reference's epsilon guard,
    MatchToolDlg.cpp:1384-1395), not NaN."""
    src = np.full((40, 60), 13, np.uint8)
    templ = rng.integers(0, 256, size=(9, 11), dtype=np.uint8)
    mean, norm, inv_area = _stats(templ)
    got = np.asarray(ncc_score_map(
        jnp.asarray(src, jnp.float32)[None], jnp.asarray(templ, jnp.float32),
        mean, norm, inv_area, False, "f32"))[0]
    ref = cv2.matchTemplate(src, templ, cv2.TM_CCOEFF_NORMED)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_window_sums(rng):
    x = rng.normal(size=(2, 20, 30)).astype(np.float32)
    got = np.asarray(window_sums(jnp.asarray(x), (5, 7)))
    want = np.zeros((2, 16, 24), np.float32)
    for i in range(16):
        for j in range(24):
            want[:, i, j] = x[:, i:i + 5, j:j + 7].sum(axis=(1, 2))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_ncc_fft_matches_opencv(rng):
    src = rng.integers(0, 256, size=(160, 190), dtype=np.uint8)
    templ = rng.integers(0, 256, size=(70, 90), dtype=np.uint8)
    ref = cv2.matchTemplate(src, templ, cv2.TM_CCOEFF_NORMED)
    mean, norm, inv_area = _stats(templ)
    got = np.asarray(ncc_score_map(
        jnp.asarray(src, jnp.float32)[None], jnp.asarray(templ, jnp.float32),
        mean, norm, inv_area, False, "f32", method="fft"))[0]
    np.testing.assert_allclose(got, ref, atol=2e-3)


def test_match_template_public_api(rng):
    from fastest_image_pattern_matching_tpu import match_template
    src = rng.integers(0, 256, size=(100, 120), dtype=np.uint8)
    templ = src[30:70, 40:95].copy()
    for method in ("conv", "fft", "auto"):
        got = match_template(src, templ, method=method)
        ref = cv2.matchTemplate(src, templ, cv2.TM_CCOEFF_NORMED)
        assert got.shape == ref.shape
        assert np.unravel_index(np.argmax(got), got.shape) == (30, 40)
        np.testing.assert_allclose(got, ref, atol=3e-3)


def test_ncc_shiftmm_matches_conv(rng):
    """Shifted-template matmul backend == conv backend (the descent
    refinement regime: small search window over a big template)."""
    H, W, h, w = 78, 109, 71, 102  # 8x8 output, area > 4096
    src = rng.integers(0, 256, size=(2, H, W), dtype=np.uint8)
    templ = rng.integers(0, 256, size=(h, w), dtype=np.uint8)
    mean, norm, inv_area = _stats(templ)
    a = np.asarray(ncc_score_map(
        jnp.asarray(src, jnp.float32), jnp.asarray(templ, jnp.float32),
        mean, norm, inv_area, False, "bf16", method="shiftmm"))
    b = np.asarray(ncc_score_map(
        jnp.asarray(src, jnp.float32), jnp.asarray(templ, jnp.float32),
        mean, norm, inv_area, False, "bf16", method="conv"))
    np.testing.assert_allclose(a, b, atol=1e-6)
    ref = cv2.matchTemplate(src[0], templ, cv2.TM_CCOEFF_NORMED)
    np.testing.assert_allclose(a[0], ref, atol=2e-3)
    # auto must route this regime to shiftmm-compatible results
    c = np.asarray(ncc_score_map(
        jnp.asarray(src, jnp.float32), jnp.asarray(templ, jnp.float32),
        mean, norm, inv_area, False, "bf16", method="auto"))
    np.testing.assert_allclose(c, a, atol=1e-6)


def _auto_calls(monkeypatch, src, templ):
    """The ccorr_* forms auto calls for one score map, and the map."""
    from fastest_image_pattern_matching_tpu.ops import ncc as ncc_mod
    calls = []
    for name in ("ccorr_conv", "ccorr_shiftmm", "ccorr_fft"):
        orig = getattr(ncc_mod, name)

        def spy(*a, _name=name, _orig=orig, **k):
            calls.append(_name)
            return _orig(*a, **k)
        monkeypatch.setattr(ncc_mod, name, spy)
    mean, norm, inv_area = _stats(templ)
    got = np.asarray(ncc_mod.ncc_score_map(
        jnp.asarray(src, jnp.float32), jnp.asarray(templ, jnp.float32),
        mean, norm, inv_area, False, "bf16", method="auto"))
    return calls, got


def test_ncc_auto_small_template_small_grid_takes_conv(rng, monkeypatch):
    """A 7x7 search over a template of at most 4096 px (the many-target
    level-0 descent) goes to the convolution, not shiftmm."""
    src = rng.integers(0, 256, size=(3, 60, 60), dtype=np.uint8)
    templ = rng.integers(0, 256, size=(54, 54), dtype=np.uint8)
    calls, got = _auto_calls(monkeypatch, src, templ)
    assert calls == ["ccorr_conv"], calls
    ref = cv2.matchTemplate(src[1], templ, cv2.TM_CCOEFF_NORMED)
    np.testing.assert_allclose(got[1], ref, atol=2e-3)


def test_ncc_auto_big_template_small_grid_takes_shiftmm(rng, monkeypatch):
    """A 7x7 search over a template of more than 4096 px (the flagship's
    lower descent levels) goes to shiftmm."""
    src = rng.integers(0, 256, size=(2, 72, 102), dtype=np.uint8)
    templ = rng.integers(0, 256, size=(66, 96), dtype=np.uint8)
    calls, got = _auto_calls(monkeypatch, src, templ)
    assert calls == ["ccorr_shiftmm"], calls
    ref = cv2.matchTemplate(src[0], templ, cv2.TM_CCOEFF_NORMED)
    np.testing.assert_allclose(got[0], ref, atol=2e-3)


def test_ncc_auto_budget_gate_fallback(rng, monkeypatch):
    """Past the convolution's launch-bound regime (B*Ho*Wo*h*w > 2^25)
    auto falls through to FFT and stays correct."""
    from fastest_image_pattern_matching_tpu.ops import ncc as ncc_mod
    H, W, h, w = 420, 440, 24, 32
    assert (H - h + 1) * (W - w + 1) * h * w > ncc_mod._CONV_MAX_MACS
    src = rng.integers(0, 256, size=(1, H, W), dtype=np.uint8)
    templ = rng.integers(0, 256, size=(h, w), dtype=np.uint8)
    calls, got = _auto_calls(monkeypatch, src, templ)
    assert calls == ["ccorr_fft"], calls
    ref = cv2.matchTemplate(src[0], templ, cv2.TM_CCOEFF_NORMED)
    np.testing.assert_allclose(got[0], ref, atol=2e-3)


def test_ncc_method_name_validated():
    import jax.numpy as jnp
    import pytest as _pytest
    from fastest_image_pattern_matching_tpu.ops.ncc import ncc_score_map
    c = jnp.zeros((1, 32, 32), jnp.float32) + 10.0
    t = jnp.arange(64, dtype=jnp.float32).reshape(8, 8)
    with _pytest.raises(ValueError, match="unknown correlation method"):
        ncc_score_map(c, t, 31.5, 100.0, 1 / 64.0, False, "bf16", "covn")
