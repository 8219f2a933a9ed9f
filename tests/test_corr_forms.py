"""Every correlation form of ops/ncc.py (conv, fft, shiftmm) and
every compute dtype against a float64 numpy correlation — the TM_CCORR
inner loop of the reference (MatchToolDlg.cpp:1275-1311) — and the
shape-only choice ncc_score_map's "auto" makes."""

import numpy as np
import pytest

import jax.numpy as jnp

from fastest_image_pattern_matching_tpu.ops import ncc

SHAPES = [
    (1, 300, 333, 27, 27),   # Test7 top-layer geometry (Dst10 54x54 / 2)
    (2, 140, 150, 5, 13),    # batched, asymmetric
    (1, 260, 139, 33, 2),    # minimal width
    (1, 200, 310, 11, 100),  # wide template
]
DTYPES = ["bf16", "f32"]


def _ccorr_f64(S, T):
    B, H, W = S.shape
    h, w = T.shape
    Ho, Wo = H - h + 1, W - w + 1
    out = np.zeros((B, Ho, Wo))
    if Ho * Wo < h * w:
        for dy in range(Ho):
            for dx in range(Wo):
                out[:, dy, dx] = np.einsum(
                    "bij,ij->b", S[:, dy:dy + h, dx:dx + w], T)
    else:
        for dy in range(h):
            for dx in range(w):
                out += S[:, dy:dy + Ho, dx:dx + Wo] * T[dy, dx]
    return out


def _centered(shape, seed):
    B, H, W, h, w = shape
    rng = np.random.default_rng(seed)
    S = rng.integers(0, 256, (B, H, W)).astype(np.float64) - 128.0
    T = rng.integers(0, 256, (h, w)).astype(np.float64) - 128.0
    return S, T


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", [ncc.ccorr_conv])
def test_exact_forms_match_f64(shape, dtype, form):
    """conv is exact in every dtype (u8-centered operands, f32
    accumulation far below 2^24 per product)."""
    S, T = _centered(shape, sum(shape))
    got = np.asarray(form(jnp.asarray(S, jnp.float32),
                          jnp.asarray(T, jnp.float32), dtype))
    np.testing.assert_array_equal(got, _ccorr_f64(S, T))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_shiftmm_matches_f64(shape, dtype):
    """shiftmm serves small output grids: the same templates over ROIs
    7 px larger than the template (the descent's 7x7 search)."""
    B, _, _, h, w = shape
    S, T = _centered((B, h + 6, w + 6, h, w), sum(shape))
    got = np.asarray(ncc.ccorr_shiftmm(jnp.asarray(S, jnp.float32),
                                       jnp.asarray(T, jnp.float32), dtype))
    np.testing.assert_array_equal(got, _ccorr_f64(S, T))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_fft_close_to_f64(shape, dtype):
    """fft is not exact: its correlation is within 1e-6 of the largest
    possible magnitude (h*w*128*128), and its scores within 1e-5 of the
    exact conv form's whatever compute dtype is asked for."""
    S, T = _centered(shape, sum(shape))
    got = np.asarray(ncc.ccorr_fft(jnp.asarray(S, jnp.float32),
                                   jnp.asarray(T, jnp.float32)))
    bound = T.size * 128.0 * 128.0
    assert np.abs(got - _ccorr_f64(S, T)).max() <= 1e-6 * bound
    args = _score_args(S + 128.0, T + 128.0)
    ref = np.asarray(ncc.ncc_score_map(*args, "f32", "conv"))
    fft = np.asarray(ncc.ncc_score_map(*args, dtype, "fft"))
    np.testing.assert_allclose(fft, ref, atol=1e-5)


def _score_args(S, T):
    area = T.size
    mean = float(np.mean(T, dtype=np.float64))
    var = float(np.mean((T.astype(np.float64) - mean) ** 2))
    return (jnp.asarray(S, jnp.float32), jnp.asarray(T, jnp.float32), mean,
            float(np.sqrt(var) * np.sqrt(area)), 1.0 / area, False)


@pytest.mark.parametrize("method", ["fft", "auto"])
def test_score_map_forms_agree_with_conv(method):
    rng = np.random.default_rng(7)
    S = rng.integers(0, 256, (1, 220, 260)).astype(np.float32)
    T = rng.integers(0, 256, (21, 17)).astype(np.float32)
    args = _score_args(S, T)
    ref = np.asarray(ncc.ncc_score_map(*args, "f32", "conv"))
    got = np.asarray(ncc.ncc_score_map(*args, "bf16", method))
    np.testing.assert_allclose(got, ref, atol=2e-6)


def test_tall_template_short_output():
    """A tall template over a short output grid, the shape that used to
    trip tiling code; every exact form agrees."""
    S, T = _centered((1, 90, 180, 57, 9), 3)
    want = _ccorr_f64(S, T)
    for dtype in DTYPES:
        got = np.asarray(ncc.ccorr_conv(jnp.asarray(S, jnp.float32),
                                        jnp.asarray(T, jnp.float32), dtype))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,want", [
    ((41, 68, 70, 9, 12), "conv"),          # flagship top-layer sweep
    ((24, 527, 768, 521, 762), "shiftmm"),  # flagship level-0 descent
    ((24, 137, 197, 131, 191), "shiftmm"),  # flagship level-2 descent
    ((24, 72, 102, 66, 96), "shiftmm"),     # flagship level-3 descent
    ((96, 39, 54, 33, 48), "conv"),         # flagship level-4 descent
    ((192, 23, 30, 17, 24), "conv"),        # flagship level-5 descent
    ((32, 60, 60, 54, 54), "conv"),         # many-target level-0 descent
    ((1, 1824, 1824, 27, 27), "fft"),       # many-target top layer
    ((1, 155, 204, 13, 18), "conv"),        # Test4 top layer
    ((24, 552, 793, 521, 762), "fft"),      # 32x32 search, big template
    ((1, 1824, 1824, 64, 64), "fft"),
])
def test_auto_choice_from_shapes(shape, want):
    """auto's choice depends on the shapes alone (PERF.md, auto table)."""
    assert ncc.choose_method(*shape) == want
