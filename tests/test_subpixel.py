"""Subpixel quadratic-fit refinement (SubPixEsimation parity,
MatchTool/MatchToolDlg.cpp:1149-1221)."""

import numpy as np
import jax.numpy as jnp

from fastest_image_pattern_matching_tpu.ops.subpixel import subpixel_refine


def _reference_subpix(patches, x0, y0, theta0_deg, step_deg):
    """Direct port of the reference's normal-equations solve in float64,
    absolute coordinates (MatchToolDlg.cpp:1149-1221)."""
    D2R = np.pi / 180.0
    A, S = [], []
    for t in range(3):
        for y in (-1, 0, 1):
            for x in (-1, 0, 1):
                dx = x0 + x
                dy = y0 + y
                dt = (theta0_deg + (t - 1) * step_deg) * D2R
                A.append([dx * dx, dy * dy, dt * dt, dx * dy, dx * dt,
                          dy * dt, dx, dy, dt, 1.0])
                S.append(patches[t, y + 1, x + 1])
    A = np.array(A)
    S = np.array(S)
    z = np.linalg.solve(A.T @ A, A.T @ S)
    K1 = np.array([[2 * z[0], z[3], z[4]],
                   [z[3], 2 * z[1], z[5]],
                   [z[4], z[5], 2 * z[2]]])
    K2 = -np.array([z[6], z[7], z[8]])
    d = np.linalg.solve(K1, K2)
    return d[0], d[1], d[2] * 180.0 / np.pi


def test_subpixel_recovers_quadratic_peak(rng):
    """A pure quadratic with known stationary point must be recovered
    exactly by both the reference formulation and ours."""
    step = 0.4
    true = (0.3, -0.2, 0.15)  # in units of (px, px, angle-steps)

    def f(x, y, t):
        return 1.0 - 0.5 * (x - true[0]) ** 2 - 0.4 * (y - true[1]) ** 2 \
            - 0.3 * (t - true[2]) ** 2 + 0.05 * x * y

    patches = np.zeros((3, 3, 3))
    for t in range(3):
        for y in range(3):
            for x in range(3):
                patches[t, y, x] = f(x - 1, y - 1, t - 1)

    got = np.asarray(subpixel_refine(
        jnp.asarray(patches, jnp.float32)[None],
        jnp.float32(step * np.pi / 180))[0])
    # Cross-term xy shifts the stationary point; compare to the reference
    # solve rather than `true`.
    rx, ry, rt = _reference_subpix(patches, 3.0, 2.0, 10.0, step)
    np.testing.assert_allclose(got[0], rx - 3.0, atol=1e-3)
    np.testing.assert_allclose(got[1], ry - 2.0, atol=1e-3)
    np.testing.assert_allclose(got[2] * 180 / np.pi, rt - 10.0, atol=1e-3)


def test_subpixel_matches_reference_on_noise(rng):
    """Arbitrary smooth patches: centered solve == reference absolute solve."""
    step = 1.7
    for _ in range(5):
        patches = rng.random((3, 3, 3)) * 0.2 + 0.8
        got = np.asarray(subpixel_refine(
            jnp.asarray(patches, jnp.float32)[None],
            jnp.float32(step * np.pi / 180))[0])
        rx, ry, rt = _reference_subpix(patches, 5.0, 4.0, 30.0, step)
        np.testing.assert_allclose(got[0], rx - 5.0, atol=5e-2)
        np.testing.assert_allclose(got[1], ry - 4.0, atol=5e-2)
        np.testing.assert_allclose(got[2] * 180 / np.pi, rt - 30.0, atol=5e-2)


def test_subpixel_degenerate_patch_no_nan():
    patches = jnp.ones((1, 3, 3, 3), jnp.float32)
    out = np.asarray(subpixel_refine(patches, jnp.float32(0.01)))
    assert np.all(np.isfinite(out))
    np.testing.assert_allclose(out, 0.0, atol=1e-6)


def test_subpixel_fit_does_not_depend_on_batch(rng):
    """A candidate's fit is bitwise the same whether it is refined among
    328 candidates or among a strided quarter of them (one card of an
    angle-sharded mesh)."""
    patches = rng.uniform(0.5, 1.0, (328, 3, 3, 3)).astype(np.float32)
    full = np.asarray(subpixel_refine(jnp.asarray(patches), 0.0123))
    for k in range(4):
        part = np.asarray(subpixel_refine(jnp.asarray(patches[k::4]), 0.0123))
        np.testing.assert_array_equal(part, full[k::4])
