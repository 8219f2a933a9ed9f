"""Subpixel (x, y, theta) refinement via a quadratic surface fit.

The reference fits a 10-coefficient quadratic over a 3x3x3 (x, y, theta)
score neighborhood with a 27x10 normal-equations least squares and solves a
3x3 system for the stationary point (SubPixEsimation,
MatchTool/MatchToolDlg.cpp:1149-1221).

Batched formulation: the fit is affine-equivariant, so we fit in *centered,
normalized* coordinates (x, y in {-1,0,1}; theta scaled to {-1,0,1}) where
the design matrix is a fixed, perfectly-conditioned constant. Its
pseudo-inverse is precomputed once in float64 and the per-candidate solve
becomes one [10,27]x[27] product plus a closed-form 3x3 solve — trivially
batched over candidates.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def _design_pinv() -> np.ndarray:
    """Pseudo-inverse of the 27x10 quadratic design matrix over the unit
    3x3x3 grid, row order (theta, y, x) like the reference's loop nest
    (MatchToolDlg.cpp:1167-1199)."""
    rows = []
    for t in (-1.0, 0.0, 1.0):
        for y in (-1.0, 0.0, 1.0):
            for x in (-1.0, 0.0, 1.0):
                rows.append([x * x, y * y, t * t, x * y, x * t, y * t,
                             x, y, t, 1.0])
    a = np.array(rows, dtype=np.float64)
    return np.linalg.pinv(a)  # [10, 27]


_PINV = _design_pinv()


def subpixel_refine(patches: jnp.ndarray, step_rad) -> jnp.ndarray:
    """Stationary point of the fitted quadratic.

    patches: [..., 3, 3, 3] scores ordered (theta, dy, dx), the 3x3 score
      neighborhoods of the (theta-1, theta, theta+1) maps around the peak.
    step_rad: angle step in radians (scalar or broadcastable to leading dims).

    Returns [..., 3]: (dx, dy, dtheta_rad) offsets relative to the center
    sample; add to the integer peak and the middle angle. A NaN-free output
    is guaranteed via a determinant guard (degenerate fits -> zero offset).
    """
    s = patches.reshape(*patches.shape[:-3], 27)
    # z = PINV @ s as 27 multiply-adds in a fixed order, not a matmul: a
    # GPU matmul library picks its kernel, and so its summation order, by
    # the batch size, so a candidate's fit would depend on how many
    # candidates share the call (each card of an angle-sharded mesh fits
    # a quarter of them). Plain f32 arithmetic, no TF32.
    pinv = jnp.asarray(_PINV, dtype=jnp.float32)
    z = s[..., 0, None] * pinv[:, 0]
    for j in range(1, 27):
        z = z + s[..., j, None] * pinv[:, j]
    k0, k1, k2, k3, k4, k5, k6, k7, k8, _ = [z[..., i] for i in range(10)]

    # Solve [2k0 k3 k4; k3 2k1 k5; k4 k5 2k2] d = -[k6 k7 k8]
    a, b, c = 2 * k0, k3, k4
    d_, e, f = k3, 2 * k1, k5
    g, h, i = k4, k5, 2 * k2
    det = a * (e * i - f * h) - b * (d_ * i - f * g) + c * (d_ * h - e * g)
    safe = jnp.abs(det) > 1e-20
    det = jnp.where(safe, det, 1.0)
    rx = -k6, -k7, -k8
    dx = (rx[0] * (e * i - f * h) - b * (rx[1] * i - f * rx[2])
          + c * (rx[1] * h - e * rx[2])) / det
    dy = (a * (rx[1] * i - f * rx[2]) - rx[0] * (d_ * i - f * g)
          + c * (d_ * rx[2] - rx[1] * g)) / det
    dt = (a * (e * rx[2] - rx[1] * h) - b * (d_ * rx[2] - rx[1] * g)
          + rx[0] * (d_ * h - e * g)) / det
    dx = jnp.where(safe, dx, 0.0)
    dy = jnp.where(safe, dy, 0.0)
    dt = jnp.where(safe, dt, 0.0)
    return jnp.stack([dx, dy, dt * step_rad], axis=-1)
