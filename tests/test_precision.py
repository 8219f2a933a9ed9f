"""Every f32 matmul or convolution whose exactness the matcher relies on
asks for HIGHEST precision. A GPU runs f32 contractions at DEFAULT
precision in TF32 (an 11-bit significand), which would round pixel
coordinates near 4000 px to 2 px steps, NCC sums over a window, and the
homography algebra. The CPU ignores the flag, so only the lowered program
shows it."""

import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fastest_image_pattern_matching_tpu.models import orb
from fastest_image_pattern_matching_tpu.ops import ncc, nms, pyramid, subpixel

_CONTRACTION = re.compile(r"stablehlo\.(dot_general|convolution)")


def _f32_contractions(fn, *args):
    """(line, is_highest) of every f32-operand dot/conv in fn's StableHLO."""
    text = jax.jit(fn).lower(*args).as_text()
    out = []
    for line in text.splitlines():
        if not _CONTRACTION.search(line):
            continue
        operands = line.rsplit(":", 1)[1].split("->")[0]
        if "xf32>" not in operands:
            continue
        highest = ("precision = [HIGHEST, HIGHEST]" in line
                   or line.count("precision HIGHEST") == 2)
        out.append((line.strip(), highest))
    return out


def _assert_all_highest(fn, *args, expect_some=True):
    found = _f32_contractions(fn, *args)
    if expect_some:
        assert found, "no f32 contraction found — test is stale"
    bad = [line for line, ok in found if not ok]
    assert not bad, bad


F32 = jnp.float32


def test_pyr_down_is_exact_f32():
    """The pyramid step's every f32 contraction (if any) is HIGHEST."""
    img = jnp.zeros((37, 53), F32)
    _assert_all_highest(pyramid.pyr_down, img, expect_some=False)


def test_nms_quad_intersection():
    q = jnp.zeros((4, 2), F32)
    _assert_all_highest(nms.quad_intersection_area, q, q)


def test_nms_clip_halfplane():
    pts = jnp.zeros((8, 2), F32)
    a = jnp.zeros((2,), F32)
    _assert_all_highest(
        lambda p, c, x, y: nms._clip_halfplane(p, c, x, y),
        pts, jnp.int32(4), a, a)


def test_subpixel_pinv():
    """The fit is a fixed-order sum of products (an exact formulation):
    no f32 contraction, so no TF32, is left in it."""
    found = _f32_contractions(subpixel.subpixel_refine,
                              jnp.zeros((5, 3, 3, 3), F32), F32(0.01))
    assert not found, found


def test_orb_project():
    _assert_all_highest(orb._project, jnp.eye(3, dtype=F32),
                        jnp.zeros((16, 2), F32))


def test_orb_ransac_refit():
    pts = jnp.asarray(np.random.default_rng(0).uniform(0, 100, (32, 2)), F32)
    _assert_all_highest(
        lambda s, d, v: orb.ransac_homography(s, d, v, 3.0, 16),
        pts, pts + 1.0, jnp.ones(32, bool))


def test_orb_harris_and_blur():
    img = jnp.zeros((48, 64), F32)
    _assert_all_highest(lambda x: orb._harris_response(x, 0.04), img)
    _assert_all_highest(
        lambda x, p, a: orb._descriptors(x, p, a), img,
        jnp.full((4, 2), 20.0, F32), jnp.zeros((4,), F32))


@pytest.mark.parametrize("form", [ncc.ccorr_conv, ncc.ccorr_shiftmm])
def test_ccorr_f32_branch(form):
    _assert_all_highest(lambda c, t: form(c, t, "f32"),
                        jnp.zeros((2, 20, 24), F32), jnp.zeros((16, 20), F32))


@pytest.mark.parametrize("dtype", ["bf16"])
@pytest.mark.parametrize("form", [ncc.ccorr_conv, ncc.ccorr_shiftmm])
def test_ccorr_narrow_branches_have_no_f32_contraction(form, dtype):
    """bf16 operands are exact by construction: no f32 contraction (and
    so no TF32 rounding) is left in that branch."""
    found = _f32_contractions(lambda c, t: form(c, t, dtype),
                              jnp.zeros((2, 20, 24), F32),
                              jnp.zeros((16, 20), F32))
    assert not found, found
