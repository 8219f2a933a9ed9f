"""chip_smoke.py off the GPU: it must refuse to run (no CPU fallback) and
print no result; its plain references must agree with the library on the
CPU, so that a mismatch on the GPU is the GPU's."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

from fastest_image_pattern_matching_tpu.ops import ncc, pyramid  # noqa: E402


def _run(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def _prints_no_result(out):
    for line in out.stdout.splitlines():
        try:
            assert not json.loads(line).get("ok")
        except (ValueError, AttributeError):
            pass


def test_exits_nonzero_without_gpu():
    out = _run(REPO)
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    _prints_no_result(out)


def test_exits_nonzero_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(str(tmp_path))
    assert out.returncode != 0
    _prints_no_result(out)


@pytest.mark.parametrize("hw", [(37, 53), (64, 64), (3, 5)])
def test_pyr_down_reference_matches_library(hw):
    img = np.random.default_rng(hw[0]).integers(0, 256, hw).astype(np.uint8)
    want = chip_smoke.pyr_down_reference(img)
    got = np.asarray(pyramid.pyr_down(jnp.asarray(img, jnp.float32)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(2, 40, 50, 9, 12), (3, 30, 31, 24, 25)])
def test_ncc_reference_matches_library(shape):
    B, H, W, h, w = shape
    rng = np.random.default_rng(B + h)
    canv = rng.integers(0, 256, (B, H, W)).astype(np.float32)
    tpl = rng.integers(0, 256, (h, w)).astype(np.float32)
    mean = float(tpl.mean(dtype=np.float64))
    norm = float(np.sqrt(np.mean((tpl - mean) ** 2.0)) * np.sqrt(h * w))
    got = np.asarray(ncc.ncc_score_map(
        jnp.asarray(canv), jnp.asarray(tpl), mean, norm, 1.0 / (h * w),
        False, "f32", "conv"))
    np.testing.assert_allclose(got, chip_smoke.ncc_reference(canv, tpl),
                               atol=2e-6)


def test_quantized_parity_rule():
    ref_unq = np.array([1.2, 2.5, 3.0, 4.49995])
    ref = np.round(ref_unq)
    ok, frac = chip_smoke.quantized_parity(ref.copy(), ref, ref_unq)
    assert ok and frac == 0.0
    big = np.tile(ref, 1000)
    got = big.copy()
    got[1] += 1.0  # a flip at the 2.5 boundary: allowed
    assert chip_smoke.quantized_parity(got, big, np.tile(ref_unq, 1000))[0]
    got = big.copy()
    got[0] += 1.0  # a flip away from a boundary: refused
    assert not chip_smoke.quantized_parity(got, big,
                                           np.tile(ref_unq, 1000))[0]
    # With the other device's unquantized values: a flip is allowed when
    # the two values straddle the boundary a little apart.
    got_unq = np.tile(ref_unq, 1000)
    got = big.copy()
    got[4 * 3 + 3] += 1.0
    got_unq[4 * 3 + 3] = 4.5001  # rounds up on this device
    assert chip_smoke.quantized_parity(got, big, np.tile(ref_unq, 1000),
                                       got_unq)[0]
    got_unq[4 * 3 + 3] = 5.2  # too far from the other device's value
    assert not chip_smoke.quantized_parity(got, big, np.tile(ref_unq, 1000),
                                           got_unq)[0]
    # The bound is chip_smoke.WARP_UNQ_BOUND (0.1): the card's sound
    # reading (0.055) passes, a 0.001 px sampling fault's (0.2) does not.
    got_unq[4 * 3 + 3] = 4.49995 + 0.055
    assert chip_smoke.quantized_parity(got, big, np.tile(ref_unq, 1000),
                                       got_unq)[0]
    got_unq[4 * 3 + 3] = 4.49995 + 0.2
    assert not chip_smoke.quantized_parity(got, big, np.tile(ref_unq, 1000),
                                           got_unq)[0]


def test_compare_allows_reordered_ties_only(monkeypatch):
    """The CPU-device comparison pairs results by position: ties within
    1e-4 may come in another order, real score differences may not."""
    from types import SimpleNamespace as R
    monkeypatch.setattr(chip_smoke, "FAILURES", [])
    a = R(score=1.0, angle=0.0, center=(10.0, 10.0))
    b = R(score=1.0 - 1e-7, angle=0.0, center=(50.0, 10.0))
    c = R(score=0.9, angle=0.0, center=(90.0, 10.0))
    chip_smoke._compare("ties", [a, b, c], [b, a, c])
    assert chip_smoke.FAILURES == []
    chip_smoke._compare("swap", [a, c, b], [a, b, c])
    assert chip_smoke.FAILURES == ["swap vs CPU device"]
    far = R(score=1.0, angle=0.0, center=(10.2, 10.0))
    chip_smoke._compare("moved", [far, b, c], [a, b, c])
    assert chip_smoke.FAILURES[-1] == "moved vs CPU device"


def test_compare_arrays_is_bitwise(monkeypatch):
    """Sharded vs single-device arrays: valid matches equal bit for bit;
    one float32 ulp of angle is a failure."""
    monkeypatch.setattr(chip_smoke, "FAILURES", [])
    ref = dict(valid=np.array([True, True, False]),
               score=np.float32([0.9, 0.8, 0.0]),
               center=np.float32([[10, 20], [30, 40], [0, 0]]),
               angle=np.float32([120.0, -0.5, 0.0]))
    chip_smoke._compare_arrays("same", dict(ref, angle=np.float32(
        [120.0, -0.5, 7.0])), ref)  # invalid slots are not compared
    assert chip_smoke.FAILURES == []
    one_ulp = dict(ref, angle=np.float32(
        [np.nextafter(np.float32(120.0), np.float32(200.0)), -0.5, 0.0]))
    chip_smoke._compare_arrays("ulp", one_ulp, ref)
    assert chip_smoke.FAILURES == ["ulp == single device"]
    moved = dict(ref, score=np.float32([0.9, 0.8 + 1e-7, 0.0]))
    chip_smoke._compare_arrays("score", moved, ref)
    assert chip_smoke.FAILURES[-1] == "score == single device"
